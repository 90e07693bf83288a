"""chol_roofline_pct: the Cholesky sweeps' bound (``flops/chol.py``: B
matrices of the i-vector's size a launch, bf16 or f32 input by the
kernel's template) over their device time."""

from benchmark.flops import chol, peaks
from benchmark.readers import kernel_name, template_args

SWEEP = "sweep_kernel"


def read(ctx):
    sel = [e for e in ctx.trace.kernels if kernel_name(e.name) == SWEEP]
    if not sel:
        return None
    b, n = ctx.cell.traffic["batch"], ctx.cell.config["ivector_dim"]
    bound = seconds = 0.0
    for e in sel:
        in_bytes = 2 if "bfloat16" in template_args(e.name) else 4
        bound += peaks.bound_s(*chol.sweep(b, n, in_bytes))
        seconds += (e.end - e.start) * 1e-9
    return 100.0 * bound / seconds
