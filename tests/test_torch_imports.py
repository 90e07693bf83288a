"""Import hygiene of the port: no module of speakerguard_tpu_torch, and not
chip_smoke.py or the port's tools for the card, imports jax (or optax,
orbax) or the JAX package speakerguard_tpu; nor does the data-parallel
tests' rank module, which spawned ranks import.  No module of the ops
layer imports a model."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "speakerguard_tpu_torch").rglob("*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "speakerguard_tpu", "flax", "optax",
                   "orbax")


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py",
                          ROOT / "tools" / "torch_pgd_rounds.py",
                          ROOT / "tools" / "chol_sweep_phases.py",
                          ROOT / "tools" / "stats_bwd_launches.py",
                          ROOT / "tools" / "ssa_svd_drivers.py",
                          ROOT / "tests" / "_torch_dp_worker.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


OPS_FILES = sorted((ROOT / "speakerguard_tpu_torch" / "ops").glob("*.py"))


@pytest.mark.parametrize("path", OPS_FILES, ids=lambda p: p.name)
def test_ops_import_no_model(path):
    """The ops layer lies below the models: no ops module imports one."""
    bad = [m for m in _imported_modules(path)
           if m.startswith("speakerguard_tpu_torch.models")]
    assert not bad, f"{path.name} imports {bad}"


# the modules of each slice, named so that a file moved out of the package
# cannot silently drop out of the checks above
SLICE_MODULES = [
    "ops/chol.py", "ops/trsv.py", "models/ivector.py", "models/gmm.py",
    "models/iv_plda.py", "models/base.py", "ops/kaldi_mfcc.py",
    "attacks/gradient.py", "adaptive/eot.py", "convert.py",
    "ops/gmm_loglike.py", "ops/gmm_stats.py", "ops/_build.py",
    "models/tdnn.py", "models/xv_plda.py", "bench.py",
    "ops/logmel.py", "models/audionet.py", "attacks/cw2.py",
    "adaptive/nes.py", "attacks/fakebob.py",
    "utils/ranges.py", "adaptive/bpda.py", "defenses/time_domain.py",
    "ops/resample.py", "ops/iir.py", "defenses/frequency_domain.py",
    "ops/kmeans.py", "defenses/feature_level.py", "defenses/registry.py",
    "models/defended.py",
    "ops/adpcm.py", "defenses/speech_compression.py", "ops/ssa.py",
    "attacks/kenan.py", "attacks/siren.py",
    "models/training.py", "optim.py", "utils/audio_io.py", "utils/native.py",
    "data/dataset.py",
    "metrics/__init__.py", "metrics/metric.py", "metrics/pesq_native.py",
    "cli/__init__.py", "cli/common.py", "cli/enroll.py",
    "cli/set_threshold.py", "cli/specify_target_label.py",
    "cli/attack_main.py", "cli/test_attack.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/input.py",
    "parallel/rank_checks.py",
    "utils/profiling.py", "cli/natural_train.py", "cli/adver_train.py",
    "ops/matmul.py",
]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_module_is_checked(rel):
    assert ROOT / "speakerguard_tpu_torch" / rel in PORT_FILES


def test_every_port_module_imports_on_cpu():
    for path in PORT_FILES:
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
