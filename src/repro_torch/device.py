"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``, and a
    CUDA device without an index is the current one (``cuda:0``), as a
    tensor placed there reports it.

    A CUDA device with no card raises: the port never falls back to the
    CPU quietly — pass ``"cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rank_device(device, local_rank: int, local_world: int,
                share_card: bool = False) -> torch.device:
    """The device of one rank of a launch: the CPU for ``"cpu"``, else the
    card ``cuda:{local_rank}`` (made the current one).

    A node with fewer cards than its ``local_world`` ranks raises unless
    ``share_card`` says that its ranks share the cards (rank r then takes
    card ``r mod n_cards``); no card at all raises as
    :func:`resolve_device` does."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    resolve_device(dev)
    n = torch.cuda.device_count()
    if n < int(local_world) and not share_card:
        raise RuntimeError(
            f"{local_world} ranks on a node with {n} card(s): pass "
            "--share-card (share_card=True) to put several ranks on one "
            "card (gloo only), or launch one rank a card")
    idx = int(local_rank) % n
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)
