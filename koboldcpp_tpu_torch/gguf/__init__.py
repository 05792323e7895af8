from .constants import GGMLType, GGUFValueType, Keys, TokenType, QK_K
from .reader import GGUFReader, TensorInfo, read_header_metadata
from .writer import GGUFWriter
from . import quants

__all__ = [
    "GGMLType", "GGUFValueType", "Keys", "TokenType", "QK_K",
    "GGUFReader", "TensorInfo", "read_header_metadata", "GGUFWriter", "quants",
]
