"""Host-side matrix generators (numpy): the port's own copies of the
Hubbard and SpinChainXXZ families and a minimal CSR."""
from .families import MatrixFamily, get_family
from .sparse import CSR, csr_from_coo
from .hubbard import Hubbard
from .spinchain import SpinChainXXZ

__all__ = [
    "MatrixFamily",
    "get_family",
    "CSR",
    "csr_from_coo",
    "Hubbard",
    "SpinChainXXZ",
]
