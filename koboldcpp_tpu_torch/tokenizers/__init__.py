from .vocab import Vocab, vocab_from_metadata
from .tokenizer import Tokenizer
from .spm import SPMTokenizer
from .bpe import BPETokenizer

__all__ = ["Vocab", "vocab_from_metadata", "Tokenizer", "SPMTokenizer", "BPETokenizer"]
