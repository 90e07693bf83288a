"""Work of the fast path's fused MFCC (ops/mfcc_fast.py, csrc/mfcc.cu) a
launch at a cell's shapes, from the mathematics once.  The operations are
the front end's FFT count (``frontend.forward``: a real FFT of each frame,
the mel bank and the DCT as products; the input gradient costs the same).
The bytes are what each direction has to move at the least, float32:
forward, the wave and the dither noise read and the features written;
backward, the features' cotangent, the wave and the noise read and the
wave's gradient written.  What the kernels keep between the directions
(the mel) and read again is left out, so the bound is never above the
truth."""

from benchmark.flops import frontend


def _bytes(cfg: dict, batch: int, samples: int) -> tuple:
    """(wave, dither noise, features) bytes of one call."""
    fe = cfg["frontend"]
    t, win, _ = frontend.frames(cfg, samples)
    noise = 4.0 * batch * t * win if fe.get("dither", 0.0) else 0.0
    return 4.0 * batch * samples, noise, 4.0 * batch * t * fe["num_ceps"]


def fwd(cfg: dict, batch: int, samples: int) -> tuple:
    """(operations, bytes) of a forward launch."""
    wave, noise, feats = _bytes(cfg, batch, samples)
    return frontend.forward(cfg, batch, samples), wave + noise + feats


def bwd(cfg: dict, batch: int, samples: int) -> tuple:
    """(operations, bytes) of an input-gradient launch."""
    wave, noise, feats = _bytes(cfg, batch, samples)
    return frontend.forward(cfg, batch, samples), feats + 2 * wave + noise
