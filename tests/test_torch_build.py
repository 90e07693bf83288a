"""The port's kernel binding (speakerguard_tpu_torch/ops/_build.py): a
library's name hashes its source and every shared header, so an edit to
either rebuilds it; each ``Library``'s argument types match its source's
extern "C" declarations, and its constants are checked on load; ``on_card``
and ``KernelWrapper.route`` send CPU tensors to the plain version, and
``_launch`` counts the launches that returned.  Nothing here needs nvcc or a
card."""

import ctypes
import importlib
import pkgutil
import re
import shutil

import pytest
import torch

from speakerguard_tpu_torch import ops
from speakerguard_tpu_torch.ops import _build


def c_declarations(name: str) -> dict:
    """{entry: [argument declarations]} of the extern "C" int functions of
    csrc/<name>.cu."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {entry: [a.strip() for a in args.split(",") if a.strip()]
            for entry, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                          src)}


def _libraries() -> dict:
    """{source name: its Library} over every module of the ops package."""
    libs = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        libs.update((v.name, v) for v in vars(mod).values()
                    if isinstance(v, _build.Library))
    return libs


ENTRIES = [(src.stem, entry) for src in sorted(_build.CSRC.glob("*.cu"))
           for entry in sorted(c_declarations(src.stem))]
C_SCALARS = {"int": _build.INT, "float": _build.FLT}


@pytest.mark.parametrize("source,entry", ENTRIES,
                         ids=[f"{s}:{e}" for s, e in ENTRIES])
def test_argtypes_match_the_source(source, entry):
    """A Library's argument types against its source's extern "C"
    declarations: the source's entry points are the table's keys, and each
    argument is a pointer where the C side takes a pointer (or the
    stream), an int or a float where it takes one.  A mismatch would
    otherwise show only on the card, as a crash."""
    lib = _libraries()[source]
    decls = c_declarations(source)
    assert set(decls) == set(lib.argtypes)
    c_args, py_args = decls[entry], lib.argtypes[entry]
    assert len(c_args) == len(py_args), (c_args, py_args)
    for c, t in zip(c_args, py_args):
        if "*" in c:
            assert t is _build.PTR, (entry, c)
        else:
            kind = re.fullmatch(r"(int|float) \w+", c)
            assert kind, (entry, c)
            assert t is C_SCALARS[kind.group(1)], (entry, c)


class _FakeEntry:
    """A C function of a loaded library: returns ``value``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, *args):
        return self.value


@pytest.mark.parametrize("tile", [256, 128])
def test_library_declares_its_entries_and_checks_its_constants(tile,
                                                               monkeypatch):
    """Loading declares each entry point (its argument types, an int
    return) and raises when a C getter disagrees with its Python value."""
    fake = type("Lib", (), {"sg_tile": _FakeEntry(tile),
                            "sg_run": _FakeEntry(0)})()
    monkeypatch.setattr(_build, "build", lambda name: "")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake)
    lib = _build.Library("tdnn_conv", {"sg_run": [_build.PTR, _build.INT],
                                       "sg_tile": []}, {"sg_tile": 256})
    if tile != 256:
        with pytest.raises(RuntimeError, match="sg_tile"):
            lib.entries()
        return
    fns = lib.entries()
    assert fns["sg_run"].argtypes == [_build.PTR, _build.INT]
    assert fns["sg_run"].restype is ctypes.c_int
    assert lib.entries() is fns


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_tensors_take_the_plain_version(device):
    """``route``: a CPU tensor goes to the plain version and is counted
    there; any device but cuda and cpu is refused, and counted nowhere."""
    w = _build.KernelWrapper()
    t = torch.zeros(2, device=device)
    if device == "cpu":
        assert not _build.on_card(t) and not w.route(t)
        assert (w.launches, w.plain_calls) == (0, 1)
        return
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        w.route(t)
    assert (w.launches, w.plain_calls) == (0, 0)


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_counts_once_the_entry_point_returns(rc, monkeypatch):
    """``Library.launch`` passes tensors by pointer and the current raw
    stream last, and raises naming the entry point when it returns an
    error; ``_launch`` counts a launch only once it has returned 0."""
    calls = []
    lib = _build.Library("tdnn_conv", {"sg_run": [_build.PTR, _build.INT,
                                                  _build.PTR]})
    lib._fns = {"sg_run": lambda *args: calls.append(args) or rc}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 1234, raising=False)
    w = _build.KernelWrapper()
    w.lib = lib
    t = torch.zeros(3)
    if rc:
        with pytest.raises(RuntimeError, match="sg_run .* error 700"):
            w._launch("sg_run", torch.device("cuda", 0), t, 5)
    else:
        w._launch("sg_run", torch.device("cuda", 0), t, 5)
    assert calls == [(t.data_ptr(), 5, 1234)]
    assert (w.launches, w.plain_calls) == (int(rc == 0), 0)


# each multi-launch wrapper's entry points, in launch order
GMM_LAUNCHES = {
    "stats_fwd": ["sg_stats_fwd_aug16", "sg_stats_fwd_loglike",
                  "sg_stats_fwd_normalise"],
    "stats_bwd": ["sg_stats_bwd_dl", "sg_stats_bwd_daug",
                  "sg_stats_bwd_chain"],
    "fused_loglike": ["sg_loglike_aug_split", "sg_loglike_split_gemm"],
}


@pytest.mark.parametrize("fails", [False, True])
@pytest.mark.parametrize("name", sorted(GMM_LAUNCHES))
def test_multi_launch_wrappers_launch_through_their_lib(name, fails,
                                                        monkeypatch):
    """A GMM wrapper's kernel route on CPU tensors, its launches recorded
    and not run: each launch goes through the wrapper's ``lib``, in order,
    and the call counts once, when its last launch has returned."""
    from speakerguard_tpu_torch.ops import gmm_loglike as L
    from speakerguard_tpu_torch.ops import gmm_stats as S
    w = getattr(S, name, None) or getattr(L, name)
    seen = []

    def launch(entry, device, *args):
        seen.append(entry)
        if fails and entry == GMM_LAUNCHES[name][-1]:
            raise RuntimeError(f"{entry} kernel launch failed")

    for mod in (L, S):
        monkeypatch.setattr(mod, "on_card", lambda t, what: True)
    monkeypatch.setattr(w, "on_card", lambda t, what: True)
    monkeypatch.setattr(w, "lib", type("Lib", (), {
        "launch": staticmethod(launch),
        "argtypes": w.lib.argtypes})())
    b, t, d, c = 2, 5, 3, 7
    x = torch.randn(b, t, d)
    proj = torch.randn(d + d * (d + 1) // 2, c)
    args = {"stats_fwd": (x, proj.bfloat16(), torch.randn(c)),
            "stats_bwd": (x, proj.bfloat16(),
                          torch.rand(b, t, c).bfloat16(), torch.randn(b, c),
                          torch.randn(b, c, d)),
            "fused_loglike": (x, proj, torch.randn(c))}[name]
    w.reset_counts()
    try:
        if fails:
            with pytest.raises(RuntimeError, match="launch failed"):
                w(*args)
        else:
            w(*args)
        assert seen == GMM_LAUNCHES[name]
        assert set(seen) <= set(w.lib.argtypes)
        assert (w.launches, w.plain_calls) == (int(not fails), 0)
    finally:
        w.reset_counts()


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "_build")
    names = {n: _build.library_path(n).name
             for n in ("gmm", "gmm_stats_fwd", "gmm_stats_bwd")}
    assert all(p.startswith(f"lib{n}-") and p.endswith(".so")
               for n, p in names.items())
    assert _build.library_path("gmm_stats_bwd") == (
        csrc / "_build" / names["gmm_stats_bwd"])

    header = csrc / "wgmma_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n).name for n in names}
    # every library's name moves with a header edit, whether or not its
    # source includes that header (the hash does not parse includes)
    assert all(after[n] != names[n] for n in names)

    src = csrc / "gmm_stats_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("gmm_stats_bwd").name != after[
        "gmm_stats_bwd"]
    assert _build.library_path("gmm_stats_fwd").name == after[
        "gmm_stats_fwd"]
