"""The yardstick's core: cells found by name, seeds, module loading, the
import check and the result line.

Everything a cell needs is named in ``BENCHMARK.json`` and found in files
of its own under ``benchmark/``:

    configs/<config>.json      the model's sizes (``file`` in BENCHMARK.json)
    traffic/<traffic>.json     the mix: driver, attack, batch, path, limits
    drivers/<driver>.py        one driver per kind of cell
    models/<model>.py          weights from the seed, the program built on them
    reference/<model>.py       the plain float32 reference
    flops/<name>.py            operations and bytes counted from the math
    metrics/<metric>.py        one reader per per-layer metric

A later cell, configuration, mix or metric is added as files and entries;
no file here needs an edit for it.
"""

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that no process of the benchmark may hold:
# JAX, its libraries and the JAX package (compared whole, so that the
# port, whose name begins with the JAX package's, is not caught)
FORBIDDEN = ("jax", "jaxlib", "flax", "speakerguard_tpu")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)    # metric entries


def derive_seed(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed, tags, indices): the
    same parts give the same seed on every machine."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def load_module(path: Path, name: str | None = None):
    """Import a file by its path (metric files carry dots in their names)."""
    name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    return load_module(path, f"bench_{kind}_{name}".replace(".", "_"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if ("workloads" in m and name in m["workloads"])
             or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer)


def forbidden_modules(modules=None) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name,
    the part before the first dot, is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def select_metrics(entries: list, values: dict) -> dict:
    """{name: {"value", "unit"}} of each entry that has a value; an
    end-to-end metric with none is a fault of the driver."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in entries if values.get(m["name"]) is not None}


def checks_text(checks: dict) -> str:
    """One line per compared number: ``name value (limit L)``."""
    return "\n".join(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in checks.items())
