"""A corpus of real English prose from files already on the host (port of
sparse_vae_tpu/data/local_corpus.py): the docstrings of every installed
Python module (read with `ast`, no code runs), the documentation files
(.md, .rst, .txt) bundled in site-packages, and the READMEs under
/usr/share/doc. One {"title", "text"} document per module or file, titled
by its path under its root, so the rest of the pipeline (tokenizer, token
cache, length filter, split) is the same as for a downloaded dataset.
`build_local_prose` gives the same documents in the same order as the JAX
package's on the same roots.
"""
from __future__ import annotations

import ast
import gzip
import os
import site
import warnings
from pathlib import Path
from typing import Iterator, List, Optional

_DOC_EXTS = {".md", ".rst", ".txt"}
_SKIP_FILE_HINTS = ("LICENSE", "NOTICE", "RECORD", "METADATA", "WHEEL",
                    "requirements", "entry_points")
_SKIP_DIR_HINTS = ("__pycache__", ".dist-info", "node_modules")


def _module_prose(path: str) -> str:
    """All docstrings of a module, in source order, joined as one
    document."""
    try:
        with open(path, encoding="utf-8", errors="ignore") as f:
            src = f.read()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SyntaxWarning)
            tree = ast.parse(src)
    except (SyntaxError, ValueError, OSError, RecursionError, MemoryError):
        return ""
    parts: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node)
            if doc:
                parts.append(doc.strip())
    return "\n\n".join(parts)


def _read_text(path: str, limit: int = 4 << 20) -> str:
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8",
                           errors="ignore") as f:
                return f.read(limit)
        with open(path, encoding="utf-8", errors="ignore") as f:
            return f.read(limit)
    except OSError:
        return ""


def _looks_english(text: str) -> bool:
    """A cheap prose filter: mostly letters, word-like spacing, and
    sentences."""
    if not text:
        return False
    sample = text[:8000]
    letters = sum(c.isalpha() for c in sample)
    spaces = sample.count(" ") + sample.count("\n")
    if letters < 0.45 * len(sample) or spaces < 0.08 * len(sample):
        return False
    return ". " in sample or ".\n" in sample


def _iter_roots() -> Iterator[Path]:
    seen = set()
    for root in site.getsitepackages() + [
            os.path.dirname(os.__file__), "/usr/share/doc"]:
        p = Path(root)
        if p.exists() and str(p) not in seen:
            seen.add(str(p))
            yield p


def build_local_prose(min_chars: int = 2000,
                      roots: Optional[List[Path]] = None) -> List[dict]:
    """[{"title", "text"}, ...] of the English prose under `roots`
    (default: site-packages, the standard library and /usr/share/doc).
    Files are visited in sorted order, so the corpus is the same in every
    run on the same files."""
    docs: List[dict] = []
    for root in (roots or list(_iter_roots())):
        for dirpath, dirnames, filenames in os.walk(root):
            if any(h in dirpath for h in _SKIP_DIR_HINTS):
                dirnames[:] = []
                continue
            dirnames.sort()
            for fname in sorted(filenames):
                if any(h in fname for h in _SKIP_FILE_HINTS):
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, root)
                text = ""
                if fname.endswith(".py"):
                    text = _module_prose(fpath)
                elif (Path(fname).suffix in _DOC_EXTS
                      or fname.endswith(tuple(e + ".gz" for e in _DOC_EXTS))
                      or fname.startswith("README")):
                    text = _read_text(fpath)
                if len(text) >= min_chars and _looks_english(text):
                    docs.append({"title": rel.replace(os.sep, "/"),
                                 "text": text})
    return docs

