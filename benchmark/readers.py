"""What the per-layer readers (``metrics/<name>.py``) share.  A reader's
``read(ctx)`` takes the traced stretch's context (``ctx.trace``, a
``trace.Trace``; ``ctx.cell``; ``ctx.calls``, the whole calls traced) and
returns a number, or None when the trace holds nothing for it: then the
metric is left out of the line."""

import re

from benchmark.flops import frontend, peaks


_NAME = re.compile(r"^(?:[\w:]+\s+)?(?:\w+::)*(\w+)\s*([<(]|$)")


def kernel_name(name: str) -> str:
    """A demangled kernel's own name, without return type, namespaces,
    template arguments or parameters: ``void (anonymous namespace)::
    sweep_kernel<float, false, false>(float const*, ...)`` is
    ``sweep_kernel``."""
    m = _NAME.match(name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else ""


def template_args(name: str) -> str:
    """The text from the kernel's name to its parameter list: ``<float,
    false, false>`` above."""
    flat = name.replace("(anonymous namespace)::", "")
    m = _NAME.match(flat)
    return flat[m.end(1):].split("(")[0] if m else ""


def is_kernel(name: str, ids) -> bool:
    return kernel_name(name) in ids


def frames(cell) -> int:
    return frontend.frames(cell.config, cell.traffic["samples"])[0]


def bound_and_time(ctx, kernels: tuple, counter, per: str):
    """(the bound of the work, the device seconds) of ``kernels`` (kernel
    ids), or None when none ran.  The work is ``counter(cfg, batch,
    frames)`` for each launch of the ``per`` kernel, which runs once a
    call of the op."""
    sel = [e for e in ctx.trace.kernels if is_kernel(e.name, kernels)]
    calls = sum(1 for e in sel if is_kernel(e.name, (per,)))
    if not calls:
        return None
    ops, nbytes = counter(ctx.cell.config, ctx.cell.traffic["batch"],
                          frames(ctx.cell))
    return (calls * peaks.bound_s(ops, nbytes),
            sum(e.end - e.start for e in sel) * 1e-9)


def roofline_pct(*parts):
    """100 x the summed bounds over the summed times of ``parts`` (each
    ``bound_and_time``'s), or None when one of them found nothing."""
    if any(p is None for p in parts):
        return None
    return 100.0 * sum(p[0] for p in parts) / sum(p[1] for p in parts)
