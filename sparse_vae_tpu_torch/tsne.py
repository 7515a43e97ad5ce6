"""t-SNE picture of gathered latents (the port of the JAX package's
tsne.py):

    python -m sparse_vae_tpu_torch.tsne <experiment> <run-name>
        [data.k=v ...]

reads the latents `gather_latents` (either package's) saved under
sparse-vae-datasets/latents/<experiment>/<run-name> in the working
directory, fits sklearn's t-SNE to the posterior means, scatters a
random subset of up to 1,000 points to sparse-vae-tsne.png, then fits an
LDA topic model (`fit_lda_topics`) over the run's corpus, rebuilt in the
working directory through this package's `cli`, and scatters the same
points coloured by each document's dominant topic to
sparse-vae-tsne-lda.png. Points join documents by the gathered
`doc_index`, with the title join as the reported fallback. sklearn,
scipy and matplotlib are imported inside the functions; this entry is
CPU work, as in the JAX package.
"""
from __future__ import annotations

import sys
from collections import Counter

import numpy as np

from .gather_latents import latents_path


def main(args):
    from datasets import Dataset

    if len(args) < 3:
        raise SystemExit(__doc__)
    experiment, name = args[1], args[2]
    dataset = Dataset.load_from_disk(str(latents_path(experiment, name)))
    latents = np.asarray(dataset["latent"], dtype=np.float32)
    titles = list(dataset["title"]) if "title" in dataset.column_names else []
    doc_indices = (list(dataset["doc_index"])
                   if "doc_index" in dataset.column_names else None)

    try:
        from sklearn.manifold import TSNE
    except ImportError:
        raise RuntimeError("sklearn must be installed for t-SNE plots")
    print("Fitting t-SNE embedding...")
    embeddings = TSNE().fit_transform(latents)
    print("Done.")

    print("Plotting random subset of up to 1,000 points in monochrome")
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    subset = np.random.choice(embeddings.shape[0],
                              min(1000, embeddings.shape[0]), replace=False)
    plt.scatter(embeddings[subset, 0], embeddings[subset, 1], s=4)
    plt.savefig("sparse-vae-tsne.png")
    print("Saved sparse-vae-tsne.png")

    topics = fit_lda_topics(experiment, name, titles, args[3:],
                            doc_indices=doc_indices)
    if topics is None:
        return
    plt.figure()
    plt.scatter(embeddings[subset, 0], embeddings[subset, 1], s=4,
                c=topics[subset], cmap="tab10")
    plt.savefig("sparse-vae-tsne-lda.png")
    print("Saved sparse-vae-tsne-lda.png (colored by LDA topic)")


def fit_lda_topics(experiment, name, titles, data_dotlist,
                   num_topics: int = 10, doc_indices=None):
    """Each latent's dominant LDA topic id, or None where sklearn or scipy
    is missing: sklearn's online LDA on bag-of-token-ids counts of the
    run's corpus (its saved data hparams, or the dotlist's), rebuilt in
    the working directory. Latents join documents by doc_index (the
    position in the train-then-test order) when present; the title join
    is the fallback, and it reports duplicate and unmatched titles."""
    try:
        from scipy.sparse import csr_matrix
        from sklearn.decomposition import LatentDirichletAllocation
    except ImportError:
        print("sklearn/scipy aren't available, so we can't fit an LDA "
              "model to color the t-SNE plot")
        return None

    from .cli import assemble_config, build_data
    from .data.text_data_module import TextDataModuleHparams
    from .training.checkpointing import load_run_meta
    cfg = assemble_config(experiment, list(data_dotlist))
    meta = load_run_meta(experiment, name)
    if not data_dotlist and meta and meta.get("data_hparams"):
        cfg.data = TextDataModuleHparams(**meta["data_hparams"])
    dm = build_data(cfg)

    docs, doc_titles = [], []
    for split in ("train", "test"):
        corpus = dm.splits[split]
        docs.extend(corpus.docs)
        doc_titles.extend(corpus.titles or
                          [f"{split}-{i}" for i in range(len(corpus))])

    print(f"Fitting LDA ({num_topics} topics) on {len(docs)} documents...")
    indptr, indices, values = [0], [], []
    for doc in docs:
        toks, counts = np.unique(np.asarray(doc, dtype=np.int64),
                                 return_counts=True)
        indices.extend(toks)
        values.extend(counts)
        indptr.append(len(indices))
    bow = csr_matrix((values, indices, indptr),
                     shape=(len(docs), dm.hparams.vocab_size))
    lda = LatentDirichletAllocation(n_components=num_topics, max_iter=10,
                                    learning_method="online", batch_size=512,
                                    random_state=0)
    doc_topics = np.argmax(lda.fit_transform(bow), axis=-1)
    print("LDA perplexity:", round(float(lda.perplexity(bow)), 1))

    if doc_indices is not None:
        idx = np.asarray(doc_indices, dtype=np.int64)
        if idx.size and idx.max() < len(doc_topics):
            return doc_topics[idx]
        print(f"doc_index out of range for the rebuilt corpus "
              f"(max {int(idx.max()) if idx.size else -1} vs "
              f"{len(doc_topics)} docs) — data hparams differ from the "
              "gather run; falling back to the title join")

    dup = sum(c - 1 for c in Counter(doc_titles).values() if c > 1)
    by_title = dict(zip(doc_titles, doc_topics))
    missing = sum(1 for t in titles if t not in by_title)
    if dup or missing:
        print(f"Title join: {dup} duplicate corpus titles collapsed, "
              f"{missing}/{len(titles)} gathered titles unmatched "
              "(defaulting those points to topic 0)")
    return np.array([by_title.get(t, 0) for t in titles], dtype=np.int64)


if __name__ == "__main__":
    main(sys.argv)
