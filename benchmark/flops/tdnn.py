"""Operations and bytes of each TDNN layer's convolution at a cell's
shapes, one direction (the forward, or the input gradient, which counts
the same), from the mathematics once: 2 B T_out C_in k C_out operations;
the bf16 input (B T C_in), weights (C_out C_in k) and output (B T_out
C_out), each read or written once.  The ReLU mask, the bias, the BN and
any padding are left out, so the bound is never above the truth."""


def layers(cfg: dict, batch: int, frames: int) -> list:
    """[(operations, bytes)] of the configuration's TDNN layers in order,
    at ``frames`` input frames: C_in of layer 1 is the front end's
    ``num_ceps``."""
    out = []
    t, c_in = frames, cfg["frontend"]["num_ceps"]
    for k, dil, c_out in cfg["tdnn"]:
        t_out = t - (k - 1) * dil
        ops = 2.0 * batch * t_out * c_in * k * c_out
        nbytes = 2.0 * (batch * t * c_in + c_out * c_in * k
                        + batch * t_out * c_out)
        out.append((ops, nbytes))
        t, c_in = t_out, c_out
    return out
