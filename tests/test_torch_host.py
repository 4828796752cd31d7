"""The port's host tier against fewshot's, and the package isolation guard.

* the synthetic generator and build_lyrics_corpus give byte-identical CSVs
  and identical packed arrays in both packages for the same seed;
* each package loads a corpus that the other packed;
* load_config on the shipped YAMLs gives the same Config, field by field;
* importing every fewshot_torch module loads no JAX and no fewshot module,
  and no source of the port or of chip_smoke.py imports them;
* a kernel library's name follows the bytes of its source and of the
  csrc/ headers it includes, so an edited header is rebuilt (no nvcc
  needed: the name is computed before any build);
* the prefix-attention, LSTM and head+CE kernels' sources hold no atomic
  operation, so their sums run in a fixed order.
"""

import dataclasses
import itertools
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fewshot import config as jconfig
from fewshot.data import corpus as jcorpus
from fewshot.data import synthetic as jsynthetic
from fewshot_torch import config as tconfig
from fewshot_torch.data import corpus as tcorpus
from fewshot_torch.data import synthetic as tsynthetic
from fewshot_torch.ops import _ext

REPO = Path(__file__).resolve().parent.parent
ARRAYS = ("songs", "song_len", "song_artist", "artist_song_ids",
          "artist_num_songs")


def _same_corpus(a, b):
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert set(a.splits) == set(b.splits)
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])
    assert list(a.artist_names) == list(b.artist_names)
    assert a.vocab.tokens == b.vocab.tokens


@pytest.mark.parametrize("extra_vocab,generic_frac,max_len",
                         [(0, 0.0, 0), (40, 0.25, 32)])
def test_synthetic_corpus_identical(tmp_path, extra_vocab, generic_frac,
                                    max_len):
    kw = dict(num_artists=6, songs_per_artist=5, seed=3,
              extra_vocab=extra_vocab, generic_frac=generic_frac)
    jsynthetic.generate_lyrics_csv(tmp_path / "j.csv", **kw)
    tsynthetic.generate_lyrics_csv(tmp_path / "t.csv", **kw)
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "t.csv").read_bytes()
    a = jcorpus.build_lyrics_corpus(tmp_path / "j.csv", tmp_path / "jc",
                                    vocab_size=80, max_len=max_len, seed=1)
    b = tcorpus.build_lyrics_corpus(tmp_path / "t.csv", tmp_path / "tc",
                                    vocab_size=80, max_len=max_len, seed=1)
    _same_corpus(a, b)


def test_corpus_files_are_shared(tmp_path):
    jsynthetic.generate_lyrics_csv(tmp_path / "l.csv", num_artists=5,
                                   songs_per_artist=4, seed=0)
    a = jcorpus.build_lyrics_corpus(tmp_path / "l.csv", tmp_path / "j",
                                    vocab_size=60, max_len=0)
    _same_corpus(a, tcorpus.PackedCorpus.load(tmp_path / "j"))
    b = tcorpus.build_lyrics_corpus(tmp_path / "l.csv", tmp_path / "t",
                                    vocab_size=60, max_len=0)
    _same_corpus(b, jcorpus.PackedCorpus.load(tmp_path / "t"))
    assert a.vocab.content_hash() == b.vocab.content_hash()


@pytest.mark.parametrize("n", [3, 4, 10, 24])
def test_make_splits_identical(n):
    a, b = jcorpus.make_splits(n, seed=5), tcorpus.make_splits(n, seed=5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


_DATA = sorted((REPO / "configs" / "data").glob("*.yaml"))
_MODEL = sorted((REPO / "configs" / "model").glob("*.yaml"))
_TASK = sorted((REPO / "configs" / "task").glob("*.yaml"))


@pytest.mark.parametrize(
    "data,model,task", list(itertools.product(_DATA, _MODEL, _TASK)),
    ids=lambda p: p.stem)
def test_load_config_matches(data, model, task):
    args = (str(data), str(model), str(task))
    try:
        want = jconfig.load_config(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tconfig.load_config(*args)
        return
    got = tconfig.load_config(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parse_overrides_matches():
    pairs = ["lr=3e-4", "seed=2", "cell=pallas", "top_p=0.9",
             "tie_embeddings=false", "corpus_dir=data/x"]
    assert tconfig.parse_overrides(pairs) == jconfig.parse_overrides(pairs)
    with pytest.raises(ValueError):
        tconfig.parse_overrides(["no_equals"])
    with pytest.raises(ValueError, match="unknown key"):
        tconfig.merge_configs({"bogus": 1})


_NO_YAML = r"""
import sys
sys.modules["yaml"] = None          # as on a machine without PyYAML
from fewshot_torch.config import load_config, parse_overrides
cfg = load_config(*sys.argv[1:4], parse_overrides(["cell=scan",
                                                   "support_cache=true"]))
print(cfg.model, cfg.cell, cfg.support_cache, cfg.lr)
"""


@pytest.mark.parametrize("model", _MODEL, ids=lambda p: p.stem)
def test_config_loads_without_pyyaml(model):
    """The port reads the shipped configs and --set values itself: the
    card machine has no PyYAML."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_YAML, str(_DATA[0]), str(model),
         str(REPO / "configs" / "task" / "episodic_cache.yaml")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = jconfig.load_config(str(_DATA[0]), str(model), str(
        REPO / "configs" / "task" / "episodic_cache.yaml"),
        jconfig.parse_overrides(["cell=scan", "support_cache=true"]))
    assert proc.stdout.split() == [want.model, want.cell,
                                   str(want.support_cache), str(want.lr)]


_GUARD = r"""
import importlib, pkgutil, sys
import fewshot_torch
names = ["fewshot_torch"] + [m.name for m in pkgutil.walk_packages(
    fewshot_torch.__path__, "fewshot_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "fewshot" or m.startswith("fewshot."))
assert not bad, bad
print(len(names))
"""


def test_isolation_guard_imports():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 32      # every module imported


_BANNED = re.compile(r"^\s*(import\s+(jax|jaxlib|fewshot)\b(?!_torch)"
                     r"|from\s+(jax|jaxlib|fewshot)(\.|\s)(?!_torch))",
                     re.MULTILINE)


def test_isolation_guard_sources():
    files = sorted((REPO / "fewshot_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 28
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"fewshot_torch/ops/head_ce.py",
            "fewshot_torch/models/unigram.py",
            "fewshot_torch/ops/prefix_attention.py",
            "fewshot_torch/ops/attention.py",
            "fewshot_torch/models/transformer.py",
            "fewshot_torch/cli.py", "fewshot_torch/utils/ckpt.py",
            "fewshot_torch/utils/metrics.py", "fewshot_torch/data/midi.py",
            "fewshot_torch/data/bpe.py",
            "fewshot_torch/models/base.py",
            "fewshot_torch/data/host_pipeline.py",
            "fewshot_torch/data/native.py",
            "fewshot_torch/parallel/mesh.py",
            "fewshot_torch/parallel/distributed.py"} <= names
    for f in files:
        hits = _BANNED.findall(f.read_text())
        assert not hits, (f, hits)


@pytest.mark.parametrize("edited", ["mma.cuh", "head_ce.cu"])
def test_library_name_follows_sources_and_headers(tmp_path, edited):
    """Editing a header renames the library of every source that includes
    it; editing a source renames its own; the others keep their names."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_ext.CSRC, csrc)
    before = {n: _ext.library_path(n, csrc) for n in _ext.SIGNATURES}
    assert before == {n: _ext.library_path(n) for n in _ext.SIGNATURES}
    users = {n for n in _ext.SIGNATURES
             if edited in {f.name for f in _ext.sources(n, csrc)}}
    assert users == ({"head_ce", "prefix_attn", "lstm_fwd", "lstm_bwd"}
                     if edited == "mma.cuh" else {"head_ce"})
    f = csrc / edited
    f.write_bytes(f.read_bytes() + b"\n// edited\n")
    after = {n: _ext.library_path(n, csrc) for n in _ext.SIGNATURES}
    assert {n for n in after if after[n] != before[n]} == users


_ATOMIC = re.compile(r"\batomic[A-Z]\w*\s*\(|\b(atom|red)\.[a-z]")


def test_prefix_attention_sources_have_no_atomics():
    """No atomicAdd (or other atomic, in C++ or PTX) outside comments in
    prefix_attn.cu or the headers it includes: the dq and dk/dv kernels
    each own their outputs and are deterministic."""
    files = _ext.sources("prefix_attn")
    assert [f.name for f in files] == ["prefix_attn.cu", "mma.cuh"]
    for f in files:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read_text(), flags=re.S)
        assert not _ATOMIC.search(code), f
    assert _ATOMIC.search("atomicAdd(dq + i, x);")
    assert _ATOMIC.search('asm("red.global.add.f32 [%0], %1;")')


def test_head_ce_sources_have_no_atomics():
    """No atomic (in C++ or PTX) outside comments in head_ce.cu or the
    headers it includes: the backward's dW/db partials are summed in chunk
    order by the caller and the bf16 forward's vocab chunks are merged in
    chunk order by one block of their cluster, so both give the same bits
    on every launch."""
    files = _ext.sources("head_ce")
    assert [f.name for f in files] == ["head_ce.cu", "mma.cuh"]
    for f in files:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read_text(), flags=re.S)
        assert not _ATOMIC.search(code), f


def test_lstm_sources_have_no_atomics():
    """No atomic (in C++ or PTX) outside comments in the LSTM kernels'
    sources or the headers they include: the persistent backward sums the
    dh partials of a cluster's blocks in a fixed order and each row tile's
    db in registers, so it gives the same bits on every launch."""
    files = {f for name in ("lstm_fwd", "lstm_bwd")
             for f in _ext.sources(name)}
    assert {f.name for f in files} == {"lstm_fwd.cu", "lstm_bwd.cu",
                                       "lstm_cluster.cuh", "mma.cuh"}
    for f in files:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read_text(), flags=re.S)
        assert not _ATOMIC.search(code), f


def test_every_package_is_packaged():
    """pyproject.toml lists every directory of fewshot_torch/ that has an
    __init__.py, and ships the C++/CUDA sources the packages build."""
    import tomllib
    conf = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"][
        "setuptools"]
    found = {p.parent.relative_to(REPO).as_posix().replace("/", ".")
             for p in (REPO / "fewshot_torch").rglob("__init__.py")}
    assert {"fewshot_torch.utils", "fewshot_torch.parallel"} <= found
    assert found <= set(conf["packages"])
    for pkg in ("fewshot_torch.ops", "fewshot_torch.data"):
        assert conf["package-data"][pkg] == ["csrc/*"]
        assert any((REPO / pkg.replace(".", "/") / "csrc").iterdir())
