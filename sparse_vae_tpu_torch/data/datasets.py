"""Corpus sources and the tokenized corpus (port of
sparse_vae_tpu/data/datasets.py).

`TokenizedCorpus` holds ragged uint16 documents and their byte counts,
saves and loads the token cache in the JAX package's npz format (one
contiguous uint16 arena, offsets and metadata: a cache written by either
package loads in the other), filters by length and splits. The sources
are the seeded `synthetic` corpus and `local-prose` (local_corpus.py);
`concatenate_into_streams` packs a corpus into fixed-length streams, the
pg19 regime.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .tokenizer import CLS_ID


@dataclass
class TokenizedCorpus:
    """Ragged uint16 documents with their byte counts, titles and labels;
    the corpus interface batching.iterate_epoch reads."""
    docs: List[np.ndarray]
    num_bytes: np.ndarray
    titles: Optional[List[str]] = None
    labels: Optional[np.ndarray] = None

    lengths: np.ndarray = field(init=False)

    def __post_init__(self):
        self.lengths = np.array([len(d) for d in self.docs], dtype=np.int64)
        self.num_bytes = np.asarray(self.num_bytes, dtype=np.int64)
        self._arena = None

    def __len__(self):
        return len(self.docs)

    def get_docs(self, indices: Sequence[int]) -> List[np.ndarray]:
        return [self.docs[i] for i in indices]

    def ensure_arena(self):
        """The contiguous uint16 token arena the batch packer reads,
        built once."""
        if self._arena is None:
            from .native import TokenArena
            self._arena = TokenArena.from_docs(self.docs)
        return self._arena

    def save(self, path) -> None:
        """The token cache: the arena's tokens and offsets, num_bytes,
        titles and labels in one npz."""
        arena = self.ensure_arena()
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path,
                 tokens=arena.tokens, offsets=arena.offsets,
                 num_bytes=self.num_bytes,
                 titles=np.asarray(self.titles if self.titles else [],
                                   dtype=object),
                 labels=(self.labels if self.labels is not None
                         else np.array([])))

    @classmethod
    def load(cls, path) -> "TokenizedCorpus":
        # The titles are an object array: the cache is this project's own
        # file, written by `save` here or in the JAX package.
        with np.load(path, allow_pickle=True) as z:
            tokens, offsets = z["tokens"], z["offsets"]
            titles = [str(t) for t in z["titles"]] if z["titles"].size \
                else None
            labels = z["labels"] if z["labels"].size else None
            num_bytes = z["num_bytes"]
        docs = [tokens[int(offsets[i]):int(offsets[i + 1])]
                for i in range(len(offsets) - 1)]
        return cls(docs=docs, num_bytes=num_bytes, titles=titles,
                   labels=labels)

    def _take(self, idx) -> "TokenizedCorpus":
        return TokenizedCorpus(
            docs=[self.docs[i] for i in idx],
            num_bytes=self.num_bytes[idx],
            titles=[self.titles[i] for i in idx] if self.titles else None,
            labels=self.labels[idx] if self.labels is not None else None)

    def filter_by_length(self, min_tokens: int,
                         max_tokens: int) -> "TokenizedCorpus":
        return self._take([i for i, n in enumerate(self.lengths)
                           if min_tokens <= n <= max_tokens])

    def split(self, test_size: int,
              seed: int = 7295) -> Dict[str, "TokenizedCorpus"]:
        """A shuffled train/test split: the first test_size documents of
        a seeded permutation are the test split."""
        order = np.random.default_rng(seed).permutation(len(self.docs))
        return {"train": self._take(order[test_size:]),
                "test": self._take(order[:test_size])}


def concatenate_into_streams(corpus: TokenizedCorpus,
                             stream_tokens: int) -> TokenizedCorpus:
    """The corpus's documents back to back, in order, cut into samples of
    `stream_tokens` tokens (the last may be shorter): the pg19 regime for
    a corpus without book-length documents. Byte counts are apportioned
    by each document's bytes per token, so bits per byte stays exact in
    total. Position 0 of every stream is set to [CLS], which the model's
    attention and z injection expect there; position 0 is never a
    next-token label."""
    if not corpus.docs:
        return corpus
    tokens = np.concatenate(corpus.docs)
    rates = np.concatenate([
        np.full(len(d), corpus.num_bytes[i] / max(len(d), 1))
        for i, d in enumerate(corpus.docs)])
    cum = np.concatenate([[0.0], np.cumsum(rates)])
    docs, num_bytes, titles = [], [], []
    for j, start in enumerate(range(0, len(tokens), stream_tokens)):
        piece = tokens[start:start + stream_tokens].copy()
        piece[0] = CLS_ID
        docs.append(piece)
        num_bytes.append(int(round(cum[start + len(piece)] - cum[start])))
        titles.append(f"stream-{j}")
    return TokenizedCorpus(docs=docs,
                           num_bytes=np.asarray(num_bytes, dtype=np.int64),
                           titles=titles)


# A first-order Markov chain over 200 words: structured enough that BPE
# merges and a small model both have signal to learn.
_SYNTH_VOCAB = (
    "the of and to in a is that for it as was with be by on not he this are "
    "at from or have an they which one you were all her she there would their "
    "we him been has when who will no more if out so up said what its about "
    "than into them can only other time new some could these two may first "
    "then do any like my now over such our man me even most made after also "
    "did many off before must well back through years much where your way down "
    "should because each just those people how too good very world still see "
    "own work long here get both between life being under never day same "
    "another know while last might great old year came come since against go "
    "used himself few house use during without again place around however "
    "small found mrs thought went say part once high general upon school every"
).split()


def synthetic_texts(num_docs: int, seed: int = 7295, min_words: int = 20,
                    max_words: int = 400) -> List[dict]:
    """Seeded pseudo-text documents [{"title", "text"}, ...]: each word
    follows one of its 8 preferred successors with probability 0.85."""
    rng = np.random.default_rng(seed)
    v = len(_SYNTH_VOCAB)
    prefs = rng.integers(0, v, size=(v, 8))
    docs = []
    for i in range(num_docs):
        n = int(rng.integers(min_words, max_words + 1))
        word = int(rng.integers(0, v))
        words = []
        for _ in range(n):
            words.append(_SYNTH_VOCAB[word])
            if rng.random() < 0.85:
                word = int(prefs[word, rng.integers(0, 8)])
            else:
                word = int(rng.integers(0, v))
        docs.append({"title": f"synthetic-{i}", "text": " ".join(words) + "."})
    return docs


def tokenize_texts(texts: List[dict], tokenizer,
                   chunk_documents: bool = False,
                   max_tokens: Optional[int] = None) -> TokenizedCorpus:
    """Tokenize raw documents, each wrapped as [CLS] ... [SEP] by the
    tokenizer's post-processor, recording each one's byte count.
    chunk_documents cuts a document longer than max_tokens into samples
    of at most max_tokens, the byte count apportioned by token share,
    where the length filter would otherwise drop it."""
    encodings = tokenizer.encode_batch([d["text"] for d in texts])
    docs, num_bytes, titles, labels = [], [], [], []
    has_labels = bool(texts) and "label" in texts[0]
    for e, d in zip(encodings, texts):
        ids = np.asarray(e.ids, dtype=np.uint16)
        pieces = [ids]
        if chunk_documents and max_tokens and len(ids) > max_tokens:
            pieces = [ids[i:i + max_tokens]
                      for i in range(0, len(ids), max_tokens)]
        doc_bytes = len(d["text"].encode())
        for j, piece in enumerate(pieces):
            docs.append(piece)
            num_bytes.append(round(doc_bytes * len(piece) / len(ids)))
            titles.append(d.get("title", "") if len(pieces) == 1
                          else f"{d.get('title', '')}#{j}")
            if has_labels:
                labels.append(d["label"])
    return TokenizedCorpus(
        docs=docs, num_bytes=np.asarray(num_bytes, dtype=np.int64),
        titles=titles,
        labels=np.asarray(labels, dtype=np.int64) if has_labels else None)


def load_raw_texts(dataset_name: str, dataset_config: Optional[str],
                   dataset_path: Optional[str], split: Optional[str],
                   synthetic_docs: int = 2000,
                   seed: int = 7295) -> List[dict]:
    """The raw documents of a dataset: 'synthetic' (seeded, generated
    here) or 'local-prose' (local_corpus.py). A Hugging Face dataset
    (`dataset_path` or a hub name) raises: it needs that library's cache
    or the network."""
    if dataset_name == "synthetic":
        return synthetic_texts(synthetic_docs, seed=seed)
    if dataset_name == "local-prose":
        from .local_corpus import build_local_prose
        return build_local_prose()
    raise NotImplementedError(
        f"dataset {dataset_name!r} (dataset_path={dataset_path!r}) needs "
        "datasets.load_dataset / load_from_disk "
        "(sparse_vae_tpu/data/datasets.py, load_raw_texts), which is not "
        "ported: it reads the Hugging Face cache or the network. Use "
        "'synthetic' or 'local-prose'.")
