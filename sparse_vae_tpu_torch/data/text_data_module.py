"""TextDataModule: the corpus pipeline behind one object (port of
sparse_vae_tpu/data/text_data_module.py): load -> tokenize (byte-level
BPE, specials [PAD]/[CLS]/[SEP]) -> token cache -> (streams) -> length
filter -> split -> token-budget batches by length bucket.

`prepare_corpus` is the half after tokenization (streams, filter, split),
so a caller with token ids already in hand, such as the card's training
check in chip_smoke.py, feeds them through the same steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from .batching import TextBatch, iterate_epoch, plan_batches
from .datasets import (TokenizedCorpus, concatenate_into_streams,
                       load_raw_texts, tokenize_texts)
from .tokenizer import bytes_per_token_table, get_or_train_tokenizer


@dataclass
class TextDataModuleHparams:
    tokens_per_batch: int = 50_000
    chunk_documents: bool = False
    # The pg19 regime for a corpus without book-length documents: the
    # tokenized documents concatenated into max_tokens_per_sample-token
    # streams before the filter and the split.
    concat_documents: bool = False
    dataset_name: str = "synthetic"
    dataset_config: Optional[str] = None
    dataset_path: Optional[str] = None
    min_tokens_per_sample: int = 16
    max_tokens_per_sample: int = 25_000
    split: Optional[str] = None
    vocab_size: int = 2 ** 15
    pad_to_multiple_of: int = 512
    synthetic_docs: int = 2000       # only for dataset_name == 'synthetic'
    test_size: Optional[int] = None  # None: min(50,000, 5% of the corpus)


class TextDataModule:
    def __init__(self, hparams: Optional[TextDataModuleHparams] = None,
                 **kwargs):
        if hparams is None:
            hparams = TextDataModuleHparams(**kwargs)
        elif kwargs:
            raise ValueError("Pass either hparams or kwargs, not both")
        self.hparams = hparams
        self._tokenizer = None
        self.splits: Dict[str, TokenizedCorpus] = {}
        self.bytes_per_token: Optional[np.ndarray] = None

    # -- tokenizer ----------------------------------------------------------
    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self.setup_tokenizer()
        return self._tokenizer

    def setup_tokenizer(self, raw_texts=None):
        hp = self.hparams

        def texts():
            docs = raw_texts if raw_texts is not None else load_raw_texts(
                hp.dataset_name, hp.dataset_config, hp.dataset_path,
                hp.split, hp.synthetic_docs)
            for d in docs:
                yield d["text"]

        self._tokenizer = get_or_train_tokenizer(
            hp.dataset_name, texts, hp.vocab_size)
        self.bytes_per_token = bytes_per_token_table(
            self._tokenizer, hp.vocab_size)

    # -- data preparation ---------------------------------------------------
    def _token_cache_path(self) -> Path:
        """The tokenized corpus's cache, keyed by every hparam that changes
        the tokenization, under sparse-vae-datasets/tokenized/ in the
        working directory (the JAX package's path and key)."""
        hp = self.hparams
        key = "-".join(str(x) for x in [
            hp.dataset_name, hp.dataset_config or "", hp.split or "",
            hp.synthetic_docs, hp.vocab_size,
            f"chunk{hp.max_tokens_per_sample}" if hp.chunk_documents else
            "whole"]).replace("/", "_")
        return (Path.cwd() / "sparse-vae-datasets" / "tokenized"
                / f"{key}.npz")

    def prepare_data(self, use_cache: bool = True):
        hp = self.hparams
        cache = self._token_cache_path()
        if use_cache and cache.exists():
            self.setup_tokenizer()
            corpus = TokenizedCorpus.load(cache)
        else:
            raw = load_raw_texts(hp.dataset_name, hp.dataset_config,
                                 hp.dataset_path, hp.split,
                                 hp.synthetic_docs)
            self.setup_tokenizer(raw_texts=raw)
            corpus = tokenize_texts(raw, self._tokenizer,
                                    chunk_documents=hp.chunk_documents,
                                    max_tokens=hp.max_tokens_per_sample)
            if use_cache:
                corpus.save(cache)
        self.prepare_corpus(corpus)

    def prepare_corpus(self, corpus: TokenizedCorpus):
        """The tokenized corpus into self.splits: streams (with
        concat_documents), the length filter, then the seeded split."""
        hp = self.hparams
        if hp.concat_documents:
            corpus = concatenate_into_streams(corpus,
                                              hp.max_tokens_per_sample)
        corpus = corpus.filter_by_length(hp.min_tokens_per_sample,
                                         hp.max_tokens_per_sample)
        test_size = hp.test_size
        if test_size is None:
            test_size = min(50_000, max(1, round(len(corpus) * 0.05)))
        self.splits = corpus.split(test_size)

    # -- batch iterators ----------------------------------------------------
    def epoch_batches(self, split: str = "train",
                      seed: Optional[int] = None,
                      drop_remainder: bool = False,
                      rows_multiple_of: int = 1,
                      pad_to_multiple_of: Optional[int] = None
                      ) -> Iterator[TextBatch]:
        """One epoch's batches of `split`, in the order of `seed`;
        pad_to_multiple_of overrides the bucket quantum for this epoch
        only."""
        rng = np.random.default_rng(seed)
        return iterate_epoch(self.splits[split],
                             self.hparams.tokens_per_batch,
                             pad_to_multiple_of
                             or self.hparams.pad_to_multiple_of, rng,
                             drop_remainder, rows_multiple_of)

    def num_batches(self, split: str = "train") -> int:
        plans = plan_batches(self.splits[split].lengths,
                             self.hparams.tokens_per_batch,
                             self.hparams.pad_to_multiple_of,
                             np.random.default_rng(0))
        return len(plans)
