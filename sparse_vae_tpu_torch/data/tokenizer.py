"""BPE tokenizer training and loading (port of
sparse_vae_tpu/data/tokenizer.py, whose numpy-only code this keeps a copy
of).

A byte-level BPE tokenizer with Roberta-style post-processing (every
document is wrapped as [CLS] ... [SEP]), special tokens [PAD] = 0,
[CLS] = 1, [SEP] = 2, cached under
``sparse-vae-pretrained/tokenizers/<dataset>.json`` in the working
directory, plus the per-token byte length table of the bits-per-byte
metric. The `tokenizers` package is imported inside the functions that
need it, so importing this module needs nothing beyond numpy.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

import numpy as np

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
SPECIAL_TOKENS = ["[PAD]", "[CLS]", "[SEP]"]


def tokenizer_cache_path(dataset_name: str,
                         root: Optional[Path] = None) -> Path:
    root = root or Path.cwd()
    return (root / "sparse-vae-pretrained" / "tokenizers"
            / f"{dataset_name}.json")


def load_tokenizer(path: Path):
    from tokenizers import Tokenizer
    return Tokenizer.from_file(str(path))


def train_tokenizer(text_iterator: Iterable[str], vocab_size: int,
                    save_path: Optional[Path] = None):
    """Train a byte-level BPE tokenizer with the project's specials and
    [CLS] ... [SEP] post-processor; with `save_path`, save it and return
    it loaded back, so the train and load paths give the same type."""
    from tokenizers.implementations import ByteLevelBPETokenizer
    from tokenizers.processors import RobertaProcessing

    tokenizer = ByteLevelBPETokenizer()
    tokenizer.train_from_iterator(
        text_iterator, vocab_size=vocab_size, special_tokens=SPECIAL_TOKENS)
    tokenizer._tokenizer.post_processor = RobertaProcessing(
        sep=("[SEP]", SEP_ID), cls=("[CLS]", CLS_ID))
    if save_path is not None:
        save_path.parent.mkdir(parents=True, exist_ok=True)
        tokenizer.save(str(save_path))
        return load_tokenizer(save_path)
    return tokenizer._tokenizer


def get_or_train_tokenizer(dataset_name: str, text_iterator_fn,
                           vocab_size: int, root: Optional[Path] = None):
    """The cached tokenizer of `dataset_name`, or one trained on
    `text_iterator_fn()` and cached. BPE saturates below the requested
    size on a small corpus, so a smaller cached vocabulary is valid (every
    id still indexes the [vocab_size] table); a larger one is not."""
    path = tokenizer_cache_path(dataset_name, root)
    if path.exists():
        tokenizer = load_tokenizer(path)
        if tokenizer.get_vocab_size() > vocab_size:
            raise ValueError(
                f"cached tokenizer vocab {tokenizer.get_vocab_size()} > "
                f"requested {vocab_size}; delete {path} to retrain")
        return tokenizer
    return train_tokenizer(text_iterator_fn(), vocab_size, save_path=path)


def bytes_per_token_table(tokenizer, vocab_size: int) -> np.ndarray:
    """Byte length of every vocabulary entry, the specials 1 byte each.
    In byte-level BPE each character of a token's string stands for one
    byte of the original text, so the count is len(token)."""
    table = np.ones(vocab_size, dtype=np.float32)
    for token, token_id in tokenizer.get_vocab().items():
        if token_id >= vocab_size:
            continue
        table[token_id] = len(token) if token_id > SEP_ID else 1
    return table
