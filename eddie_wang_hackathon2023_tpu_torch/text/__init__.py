"""Tokenizer (tiktoken-free), language table, WER normalisers and WER."""
from .languages import LANGUAGES, TO_LANGUAGE_CODE
from .normalizers import BasicTextNormalizer, EnglishTextNormalizer
from .tokenizer import Tokenizer, get_tokenizer
from .wer import wer, wer_single

__all__ = ["BasicTextNormalizer", "EnglishTextNormalizer", "LANGUAGES",
           "TO_LANGUAGE_CODE", "Tokenizer", "get_tokenizer", "wer",
           "wer_single"]
