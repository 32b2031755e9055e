from .tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer"]
