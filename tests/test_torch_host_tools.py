"""The port's host tools against the JAX package's: preprocessing.py,
convert_formats.py and utils/results_viewer.py (copied with only the
imports changed) write the same bytes on the JAX tests' own inputs, and
data/native.py builds native/fast_text.cpp into build/native/ at first use,
never opening the prebuilt native/libmmfast.so.

Each JAX CLI test of tests/test_utils_tools.py and tests/test_convert_formats.py
runs here with its subprocess call replaced by two in-process calls of the
modules' ``main`` (which dispatches to their ``cmd_*`` functions): the JAX
module writes every output beside the test's path (``.jax``), the port's
module writes the test's own path, which the JAX test's assertions then read,
and every output and the printed text must be the same bytes."""

import ctypes
import inspect
import io
import os
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

import tests.test_convert_formats as conv_tests
import tests.test_utils_tools as prep_tests
from matchmaker_tpu import convert_formats as jconv
from matchmaker_tpu import preprocessing as jprep
from matchmaker_tpu.utils import results_viewer as jviewer
from tests.test_utils_tools import prep_files  # noqa: F401  (the JAX tests' fixture)

from matchmaker_tpu_torch import convert_formats as tconv
from matchmaker_tpu_torch import preprocessing as tprep
from matchmaker_tpu_torch.data import native
from matchmaker_tpu_torch.utils import results_viewer as tviewer


def _is_output_flag(arg: str) -> bool:
    return arg.startswith("--") and (arg.startswith("--out") or arg.endswith("-out"))


def _main_in_process(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main()
    return rc, buf.getvalue()


def _twin(jax_main, port_main, args, monkeypatch):
    """Both modules' ``main`` on ``args``: the JAX one's outputs to
    ``<path>.jax``, the port's to the paths asked for; the same return
    code, printed text and output bytes."""
    outs = [i + 1 for i, a in enumerate(args[:-1]) if _is_output_flag(a)]
    assert outs, args
    jargs = [a + ".jax" if i in outs else a for i, a in enumerate(args)]
    want = _main_in_process(jax_main, jargs, monkeypatch)
    got = _main_in_process(port_main, list(args), monkeypatch)
    assert got == (want[0], want[1].replace(".jax", "")), args
    for i in outs:
        with open(args[i], "rb") as f, open(jargs[i], "rb") as g:
            assert f.read() == g.read(), args[i]
    return SimpleNamespace(returncode=got[0] or 0, stdout=got[1], stderr="")


def _call_jax_test(module, name, tmp_path, request):
    fn = getattr(module, name)
    kwargs = {p: tmp_path if p == "tmp_path" else request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)


_PREP_TESTS = sorted(n for n in dir(prep_tests) if n.startswith("test_preprocessing"))
_CONV_TESTS = sorted(n for n, f in vars(conv_tests).items()
                     if n.startswith("test_") and "_run(" in inspect.getsource(f))


@pytest.mark.parametrize("name", _PREP_TESTS)
def test_port_preprocessing_writes_the_jax_modules_bytes(name, tmp_path, monkeypatch, request):
    monkeypatch.setattr(prep_tests, "_run_prep", lambda args: _twin(jprep.main, tprep.main, args, monkeypatch))
    _call_jax_test(prep_tests, name, tmp_path, request)


@pytest.mark.parametrize("name", _CONV_TESTS)
def test_port_convert_formats_writes_the_jax_modules_bytes(name, tmp_path, monkeypatch, request):
    monkeypatch.setattr(conv_tests, "_run", lambda args: _twin(jconv.main, tconv.main, args, monkeypatch).stdout)
    _call_jax_test(conv_tests, name, tmp_path, request)


def test_the_jax_cli_tests_are_all_driven():
    assert len(_PREP_TESTS) >= 9 and len(_CONV_TESTS) >= 9


def test_results_viewer_prints_the_jax_table(tmp_path, monkeypatch):
    """Three run folders (best-info.csv, a metrics CSV, an efficiency file;
    one folder without results): the same table, sorted by a metric."""
    for i, (value, mrr) in enumerate([("0.31", "0.30"), ("0.35", "0.33"), (None, None)]):
        run = tmp_path / f"run_{i}"
        run.mkdir()
        if value is None:
            (run / "notes.txt").write_text("nothing")
            continue
        (run / "best-info.csv").write_text(f"metric,value,epoch\nMRR@10,{value},{i}\n")
        (run / "validation-metrics.csv").write_text(f"MRR@10,Recall@1000\n0.1,0.5\n{mrr},0.9{i}\n")
        (run / "efficiency-metrics.json").write_text('[{"blocks": {"train": {"total_seconds": %d}}}]' % (3600 * i + 90))
    for argv in ([str(tmp_path)], [str(tmp_path), "validation:MRR@10"]):
        want = _main_in_process(jviewer.main, argv, monkeypatch)
        got = _main_in_process(tviewer.main, argv, monkeypatch)
        assert got == want and want[0] == 0 and "run_1" in got[1].splitlines()[1]


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """data/native.py building into a folder of the test's own."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path / "build" / "native"


def test_native_builds_into_build_native_and_never_opens_the_prebuilt_library(fresh_native, monkeypatch, tmp_path):
    """At first use fast_text.cpp is compiled into
    build/native/libmmfast_<digest>.so; the tracked native/libmmfast.so is
    never opened. The tokenizer and the triple reader then match the JAX
    package's native bindings."""
    opened = []
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda path, *a, **k: opened.append(str(path)) or real_cdll(path, *a, **k))
    assert native.native_available()
    assert opened == [str(native.library_path())]
    assert native.library_path().parent == fresh_native
    assert native.library_path().name.startswith("libmmfast_") and native.library_path().exists()
    assert not any(p.endswith(os.path.join("native", "libmmfast.so")) for p in opened)
    assert native.load_library() is native.load_library() and len(opened) == 1

    from matchmaker_tpu.data.native import NativeTripleReader as JaxReader
    from matchmaker_tpu.data.native import NativeVocabTokenizer as JaxTokenizer

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("hello\nworld\ntest\n,\n" + "\n".join(f"word{i}" for i in range(50)))
    texts = ["Hello world, TEST unknownword", "world hello", "", "word7 word49 filler word3"]
    for mask_oov in (False, True):
        got = native.NativeVocabTokenizer(str(vocab), mask_oov=mask_oov)
        want = JaxTokenizer(str(vocab), mask_oov=mask_oov)
        assert got.vocab_size == want.vocab_size
        for a, b in zip(got.encode_batch(texts, 8), want.encode_batch(texts, 8)):
            np.testing.assert_array_equal(a, b)
    triples = tmp_path / "triples.tsv"
    triples.write_text("q one\tpos one\tneg one\nq two\tpos two\tneg two\nq three\tpos three\tneg three\n")
    got, want = native.NativeTripleReader(str(triples)), JaxReader(str(triples))
    for _ in range(3):
        assert got.next_batch(2) == want.next_batch(2)
    with pytest.raises(FileNotFoundError):
        native.NativeVocabTokenizer(str(tmp_path / "missing.txt"))


def test_native_raises_the_build_error(fresh_native, monkeypatch, tmp_path):
    """A source that does not compile: native_available() is False and the
    tokenizer and the reader raise with the compiler's message."""
    bad = tmp_path / "fast_text.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    assert not native.native_available()
    for make in (lambda: native.NativeVocabTokenizer(str(bad)), lambda: native.NativeTripleReader(str(bad))):
        with pytest.raises(RuntimeError, match="could not be built"):
            make()
    assert not list(fresh_native.glob("*.so"))
