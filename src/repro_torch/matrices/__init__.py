"""Host-side matrix generators (numpy): the port's own copies of the six
families of the JAX package (Hubbard, SpinChainXXZ, Exciton, TopIns,
RoadNet, HubNet), the windowed generator protocol and a minimal CSR."""
from .families import MatrixFamily, available_families, get_family
from .sparse import CSR, csr_from_coo
from .exciton import Exciton
from .hubbard import Hubbard
from .hubnet import HubNet
from .roadnet import RoadNet
from .spinchain import SpinChainXXZ
from .topins import TopIns

__all__ = [
    "MatrixFamily",
    "available_families",
    "get_family",
    "CSR",
    "csr_from_coo",
    "Exciton",
    "Hubbard",
    "HubNet",
    "RoadNet",
    "SpinChainXXZ",
    "TopIns",
]
