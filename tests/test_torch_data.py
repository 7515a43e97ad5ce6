"""The port's corpus pipeline (sparse_vae_tpu_torch/data/) against the JAX
package's (sparse_vae_tpu/data/) on the CPU: the tokenizer, the token
cache, streams, the length filter and the split, length buckets, batch
plans, epochs of batches, the data module, the local-prose corpus, and
`load_raw_texts` on Hugging Face datasets saved to disk (a Dataset and a
DatasetDict, with and without titles and labels) and its hub branch
(`datasets.load_dataset` replaced by a stand-in: nothing is fetched).

The same inputs go through both packages in one process. Everything here
is integer or string data, so the tolerance is none: equal vocabularies,
equal ids, equal arrays bit for bit (dtype included), equal documents.
The JAX package packs batches with its C++ packer (native/, which
tests/conftest.py builds); the port with its numpy version.

Worker time: about 15 s.
"""
import gzip
import sys

import numpy as np
import pytest

from sparse_vae_tpu.data import batching as jb
from sparse_vae_tpu.data import datasets as jd
from sparse_vae_tpu.data import local_corpus as jl
from sparse_vae_tpu.data import native as jn
from sparse_vae_tpu.data import text_data_module as jt
from sparse_vae_tpu.data import tokenizer as jtok
from sparse_vae_tpu_torch.data import batching as tb
from sparse_vae_tpu_torch.data import datasets as td
from sparse_vae_tpu_torch.data import local_corpus as tl
from sparse_vae_tpu_torch.data import native as tn
from sparse_vae_tpu_torch.data import text_data_module as tt
from sparse_vae_tpu_torch.data import tokenizer as ttok


def assert_corpus_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got.docs, want.docs):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for name in ("num_bytes", "lengths"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.titles == want.titles
    if want.labels is None:
        assert got.labels is None
    else:
        np.testing.assert_array_equal(got.labels, want.labels)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("token_ids", "num_tokens", "num_bytes"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def ragged_docs(seed: int, n: int, max_len: int, min_len: int = 16):
    """n uint16 documents [CLS] ids [SEP], lengths log-uniform in
    [min_len, max_len], with byte counts and labels."""
    rng = np.random.default_rng(seed)
    lengths = np.exp(rng.uniform(np.log(min_len), np.log(max_len),
                                 size=n)).astype(np.int64)
    docs = []
    for n_tok in lengths:
        d = rng.integers(3, 32768, size=n_tok).astype(np.uint16)
        d[0], d[-1] = 1, 2
        docs.append(d)
    num_bytes = (lengths * rng.uniform(3.0, 5.0, size=n)).astype(np.int64)
    titles = [f"doc-{i}" for i in range(n)]
    labels = rng.integers(0, 5, size=n)
    return docs, num_bytes, titles, labels


@pytest.fixture(scope="module")
def texts():
    return jd.synthetic_texts(300, seed=3)


@pytest.fixture(scope="module")
def tokenizers(texts):
    """Each package's tokenizer trained on the same texts (vocab 1024)."""
    return (jtok.train_tokenizer(iter([d["text"] for d in texts]), 1024),
            ttok.train_tokenizer(iter([d["text"] for d in texts]), 1024))


def test_synthetic_texts_are_the_same():
    assert td.synthetic_texts(50, seed=11) == jd.synthetic_texts(50, seed=11)


def test_tokenizer_same_vocabulary_ids_and_byte_table(tokenizers, texts):
    jax_tok, torch_tok = tokenizers
    assert torch_tok.get_vocab() == jax_tok.get_vocab()
    vocab = torch_tok.get_vocab()
    assert (vocab["[PAD]"], vocab["[CLS]"], vocab["[SEP]"]) == (0, 1, 2)
    for d in texts[:50]:
        ids = torch_tok.encode(d["text"]).ids
        assert ids == jax_tok.encode(d["text"]).ids
        assert ids[0] == ttok.CLS_ID and ids[-1] == ttok.SEP_ID
    table = ttok.bytes_per_token_table(torch_tok, 1024)
    want = jtok.bytes_per_token_table(jax_tok, 1024)
    assert table.dtype == want.dtype
    np.testing.assert_array_equal(table, want)


def test_tokenize_texts_is_the_same(tokenizers, texts):
    jax_tok, torch_tok = tokenizers
    labelled = [{**d, "label": i % 3} for i, d in enumerate(texts[:60])]
    for chunk in (False, True):
        got = td.tokenize_texts(labelled, torch_tok, chunk_documents=chunk,
                                max_tokens=40)
        want = jd.tokenize_texts(labelled, jax_tok, chunk_documents=chunk,
                                 max_tokens=40)
        assert_corpus_equal(got, want)


def test_token_cache_loads_across_packages(tmp_path):
    docs, num_bytes, titles, labels = ragged_docs(1, 40, 3000)
    jax_corpus = jd.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                    titles=titles, labels=labels)
    torch_corpus = td.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                      titles=titles, labels=labels)
    jax_corpus.save(tmp_path / "jax.npz")
    torch_corpus.save(tmp_path / "torch.npz")
    assert_corpus_equal(td.TokenizedCorpus.load(tmp_path / "jax.npz"),
                        jd.TokenizedCorpus.load(tmp_path / "jax.npz"))
    assert_corpus_equal(jd.TokenizedCorpus.load(tmp_path / "torch.npz"),
                        td.TokenizedCorpus.load(tmp_path / "torch.npz"))
    with np.load(tmp_path / "jax.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "torch.npz", allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # Without titles or labels too.
    bare = td.TokenizedCorpus(docs=docs[:5], num_bytes=num_bytes[:5])
    bare.save(tmp_path / "bare.npz")
    assert_corpus_equal(jd.TokenizedCorpus.load(tmp_path / "bare.npz"),
                        jd.TokenizedCorpus(docs=docs[:5],
                                           num_bytes=num_bytes[:5]))


def test_token_arena_and_packer_are_the_same():
    """The arena's tokens and offsets, a packed batch (the JAX side by its
    C++ packer) and bucket_lengths."""
    docs = ragged_docs(2, 12, 500)[0]
    got, want = tn.TokenArena.from_docs(docs), jn.TokenArena.from_docs(docs)
    for name in ("tokens", "offsets", "lengths"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for idx, rows, length in (([3, 0, 7], 5, 256), ([11], 1, 512),
                              ([], 2, 128)):
        for a, b in zip(tn.pack_batch(got, idx, rows, length),
                        jn.pack_batch(want, idx, rows, length)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tn.bucket_lengths(got.lengths, 512),
                                  jn.bucket_lengths(want.lengths, 512))


@pytest.mark.parametrize("stream_tokens", [512, 1000, 4096])
def test_streams_filter_and_split_are_the_same(stream_tokens):
    docs, num_bytes, titles, labels = ragged_docs(4, 60, 2000)
    jax_corpus = jd.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                    titles=titles, labels=labels)
    torch_corpus = td.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                      titles=titles, labels=labels)
    got = td.concatenate_into_streams(torch_corpus, stream_tokens)
    want = jd.concatenate_into_streams(jax_corpus, stream_tokens)
    assert_corpus_equal(got, want)
    assert_corpus_equal(torch_corpus.filter_by_length(100, 900),
                        jax_corpus.filter_by_length(100, 900))
    for seed in (7295, 1):
        got, want = torch_corpus.split(7, seed), jax_corpus.split(7, seed)
        for name in ("train", "test"):
            assert_corpus_equal(got[name], want[name])


def test_length_bucket_is_the_same():
    for n in list(range(1, 5000, 37)) + [8192, 8193, 50_000, 57_344,
                                         60_000, 102_400, 102_401]:
        for multiple, coarsen in ((512, 8), (128, 8), (512, 0), (256, 4)):
            assert (tb.length_bucket(n, multiple, coarsen)
                    == jb.length_bucket(n, multiple, coarsen))


@pytest.mark.parametrize("rows_multiple_of,drop_remainder",
                         [(1, False), (4, False), (1, True), (3, True)])
def test_plan_batches_is_the_same(rows_multiple_of, drop_remainder):
    lengths = ragged_docs(5, 300, 60_000)[0]
    lengths = [len(d) for d in lengths]
    for seed in (0, 9):
        got = tb.plan_batches(lengths, 100_000, 512,
                              np.random.default_rng(seed), drop_remainder,
                              rows_multiple_of)
        want = jb.plan_batches(lengths, 100_000, 512,
                               np.random.default_rng(seed), drop_remainder,
                               rows_multiple_of)
        assert [vars(p) for p in got] == [vars(p) for p in want]
    # Coarsened buckets occur: past 4,096 tokens they are not all
    # multiples of 512 steps apart.
    assert any(p.bucket_len > 4096 and p.bucket_len % 1024 == 0
               for p in got)


def test_exact_bucket_rule_is_the_same():
    """At most four distinct lengths (concatenated streams): exact
    512-multiple buckets, so 102,400-token streams stay [1, 102400]."""
    lengths = [102_400] * 6 + [40_000]
    got = tb.plan_batches(lengths, 102_912, 512, np.random.default_rng(0))
    want = jb.plan_batches(lengths, 102_912, 512, np.random.default_rng(0))
    assert [vars(p) for p in got] == [vars(p) for p in want]
    assert {(p.rows, p.bucket_len) for p in got} == {(1, 102_400),
                                                     (2, 40_448)}


def test_collate_is_the_same():
    docs, num_bytes, _, _ = ragged_docs(6, 5, 900)
    plan = tb.BatchPlan(bucket_len=512, rows=7, doc_indices=list(range(5)))
    jplan = jb.BatchPlan(bucket_len=512, rows=7, doc_indices=list(range(5)))
    assert_batches_equal([tb.collate(plan, docs, num_bytes)],
                         [jb.collate(jplan, docs, num_bytes)])


def test_two_epochs_of_batches_are_the_same():
    """A ragged corpus of up to 60,000 tokens (so the coarsened buckets
    occur) over two epochs: every batch equal bit for bit, the JAX side
    packed by its C++ packer, the port's by numpy."""
    docs, num_bytes, titles, _ = ragged_docs(7, 120, 60_000)
    jax_corpus = jd.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                    titles=titles)
    torch_corpus = td.TokenizedCorpus(docs=docs, num_bytes=num_bytes,
                                      titles=titles)
    shapes = set()
    for epoch in range(2):
        got = list(tb.iterate_epoch(torch_corpus, 100_000, 512,
                                    np.random.default_rng(7295 + epoch)))
        want = list(jb.iterate_epoch(jax_corpus, 100_000, 512,
                                     np.random.default_rng(7295 + epoch)))
        assert_batches_equal(got, want)
        shapes |= {b.token_ids.shape for b in got}
    assert (1, 61_440) in shapes or any(L > 8192 for _, L in shapes)
    # Without an arena the collate path gives the same batches.
    plain = tb.iterate_epoch(_NoArena(torch_corpus), 100_000, 512,
                             np.random.default_rng(7296))
    assert_batches_equal(list(plain), want)


class _NoArena:
    def __init__(self, corpus):
        self.lengths, self.num_bytes = corpus.lengths, corpus.num_bytes
        self.get_docs = corpus.get_docs


def _prepared(module, tmp_path, monkeypatch, **kw):
    tmp_path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    dm = module.TextDataModule(module.TextDataModuleHparams(
        dataset_name="synthetic", synthetic_docs=300, vocab_size=1024,
        min_tokens_per_sample=16, max_tokens_per_sample=512,
        tokens_per_batch=4096, **kw))
    dm.prepare_data()
    return dm


@pytest.mark.parametrize("concat", [False, True])
def test_data_module_prepare_data_is_the_same(tmp_path, monkeypatch,
                                              concat):
    """prepare_data on the synthetic corpus, each package in a working
    directory of its own (its own tokenizer and token cache), then again
    from each one's cache: the same splits, batches and byte tables."""
    got = _prepared(tt, tmp_path / "torch", monkeypatch,
                    concat_documents=concat)
    want = _prepared(jt, tmp_path / "jax", monkeypatch,
                     concat_documents=concat)
    for name in ("train", "test"):
        assert_corpus_equal(got.splits[name], want.splits[name])
    np.testing.assert_array_equal(got.bytes_per_token, want.bytes_per_token)
    assert got.num_batches("train") == want.num_batches("train")
    assert_batches_equal(list(got.epoch_batches("train", seed=3)),
                         list(want.epoch_batches("train", seed=3)))
    assert_batches_equal(list(got.epoch_batches("test", seed=0)),
                         list(want.epoch_batches("test", seed=0)))
    assert got._token_cache_path().name == want._token_cache_path().name
    # The port prepares from the JAX package's cache and tokenizer.
    cached = _prepared(tt, tmp_path / "jax", monkeypatch,
                       concat_documents=concat)
    for name in ("train", "test"):
        assert_corpus_equal(cached.splits[name], want.splits[name])


def test_prepare_corpus_is_prepare_data_after_tokenization(tmp_path,
                                                           monkeypatch):
    dm = _prepared(tt, tmp_path, monkeypatch)
    corpus = td.TokenizedCorpus.load(dm._token_cache_path())
    other = tt.TextDataModule(dm.hparams)
    other.prepare_corpus(corpus)
    for name in ("train", "test"):
        assert_corpus_equal(other.splits[name], dm.splits[name])


def test_hub_datasets_raise_not_implemented(monkeypatch):
    """A hub dataset is no longer refused: it goes to
    datasets.load_dataset with the name, config and split, as in JAX
    (here a stand-in, so nothing reaches the network). Without the
    `datasets` package the error names it."""
    hfd = pytest.importorskip("datasets")
    asked = []

    def load_dataset(path, name=None, split=None):
        asked.append((path, name, split))
        return hfd.Dataset.from_dict({"text": ["a b", "c"]})

    monkeypatch.setattr(hfd, "load_dataset", load_dataset)
    got = td.load_raw_texts("wikipedia", "20200501.en", None, "train")
    assert asked == [("wikipedia", "20200501.en", "train")]
    assert got == [{"text": "a b"}, {"text": "c"}]
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets' package"):
        td.load_raw_texts("wikipedia", "20200501.en", None, None)


def _hf_saved(tmp_path, split_dict: bool, columns: dict):
    """A small Hugging Face dataset (a DatasetDict of two splits when
    split_dict) saved with save_to_disk under tmp_path: its path."""
    hfd = pytest.importorskip("datasets")
    ds = hfd.Dataset.from_dict(columns)
    if split_dict:
        half = len(ds) // 2
        ds = hfd.DatasetDict({"train": ds.select(range(half)),
                              "test": ds.select(range(half, len(ds)))})
    path = tmp_path / ("dict" if split_dict else "flat")
    ds.save_to_disk(str(path))
    return str(path)


@pytest.mark.parametrize("split_dict", [False, True])
@pytest.mark.parametrize("columns", ["title_label", "book_title", "text"])
def test_load_raw_texts_from_disk_is_the_same(tmp_path, split_dict,
                                              columns):
    """load_from_disk of a saved Dataset or DatasetDict (its splits
    joined): the documents, titles (`title` or `short_book_title`) and
    labels equal the JAX package's, exactly."""
    text = [_prose(i + 1) + f" doc {i}" for i in range(6)]
    cols = {"title_label": {"text": text,
                            "title": [f"t{i}" for i in range(6)],
                            "label": [i % 3 for i in range(6)]},
            "book_title": {"text": text,
                           "short_book_title": [f"b{i}" for i in range(6)]},
            "text": {"text": text}}[columns]
    path = _hf_saved(tmp_path, split_dict, cols)
    want = jd.load_raw_texts("ignored", None, path, None)
    got = td.load_raw_texts("ignored", None, path, None)
    assert got == want and len(got) == 6


def _prose(n: int) -> str:
    return " ".join(["The quick brown fox jumps over the lazy dog."] * n)


def test_local_prose_is_the_same(tmp_path):
    root = tmp_path / "site"
    (root / "pkg" / "sub").mkdir(parents=True)
    (root / "pkg" / "__pycache__").mkdir()
    (root / "pkg" / "mod.py").write_text(
        f'"""{_prose(30)}"""\n\n\ndef f():\n    """{_prose(20)}"""\n')
    (root / "pkg" / "broken.py").write_text("def (:\n")
    (root / "pkg" / "sub" / "manual.md").write_text(_prose(60))
    (root / "pkg" / "README").write_text(_prose(50))
    (root / "pkg" / "LICENSE.txt").write_text(_prose(60))
    (root / "pkg" / "short.txt").write_text(_prose(2))
    (root / "pkg" / "numbers.txt").write_text("1 2 3 4 " * 1000)
    (root / "pkg" / "__pycache__" / "x.txt").write_text(_prose(60))
    with gzip.open(root / "pkg" / "notes.rst.gz", "wt") as f:
        f.write(_prose(70))
    got = tl.build_local_prose(roots=[root])
    want = jl.build_local_prose(roots=[root])
    assert got == want
    assert sorted(d["title"] for d in got) == [
        "pkg/README", "pkg/mod.py", "pkg/notes.rst.gz", "pkg/sub/manual.md"]
    assert tl.build_local_prose(min_chars=100, roots=[root]) == \
        jl.build_local_prose(min_chars=100, roots=[root])
