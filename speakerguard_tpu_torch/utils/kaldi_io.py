"""Parsers for Kaldi text-format model artifacts -> numpy arrays.

A copy of speakerguard_tpu/utils/kaldi_io.py (numpy only), kept in the port
so that it imports nothing of the JAX package.

Covers the artifact set consumed by the reference:
  * full-covariance GMM  (<GCONSTS> <WEIGHTS> <MEANS_INVCOVARS> <INV_COVARS>)
    — reference model/_iv_plda/gmm.py:31-81
  * ivector extractor    (<w_vec> <M> <SigmaInv> <IvectorOffset>)
    — reference model/_iv_plda/ivector_extract.py:28-70
  * PLDA                 (mean / transform / psi rows)
    — reference model/_iv_plda/plda.py:27-51
  * global mean vector / LDA transform matrix
    — reference model/utils.py:50-80
  * enroll "speaker model" index files
    — reference model/utils.py:21-47 (z-norm stats + per-speaker emb paths)

Each parser has a ``.npz`` cache next to the source file (replacing the
reference's pickle caches, iv_plda.py:30-56).
"""

import os

import numpy as np


def _cached(path: str, parse_fn):
    cache = path + ".npz"
    if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        with np.load(cache) as z:
            return dict(z)
    out = parse_fn(path)
    try:
        np.savez(cache, **out)
    except OSError:
        pass
    return out


def _floats(tokens):
    return np.array([float(t) for t in tokens], dtype=np.float64)


def parse_fgmm_file(path: str) -> dict:
    """Returns dict(gconsts, weights, means_invcovars, invcovars)."""
    def _parse(path):
        out = {}
        with open(path) as f:
            line = f.readline()
            while line:
                if "<GCONSTS>" in line:
                    out["gconsts"] = _floats(line.split()[2:-1])
                    line = f.readline()
                elif "<WEIGHTS>" in line:
                    out["weights"] = _floats(line.split()[2:-1])
                    line = f.readline()
                elif "<MEANS_INVCOVARS>" in line:
                    c = len(out["gconsts"])
                    rows = []
                    line = f.readline()
                    for _ in range(c):
                        rows.append(_floats(line.split(" ")[2:-1]))
                        line = f.readline()
                    out["means_invcovars"] = np.stack(rows)
                elif "<INV_COVARS>" in line:
                    # reading pattern mirrors reference gmm.py:66-76: per
                    # component, d triangular rows then a separator line
                    c, d = out["means_invcovars"].shape
                    inv = np.zeros((c, d, d))
                    for i in range(c):
                        line = f.readline()
                        for j in range(d):
                            vals = _floats(line.split(" ")[:-1])
                            inv[i, j, :j + 1] = vals[:j + 1]
                            inv[i, :j + 1, j] = vals[:j + 1]
                            line = f.readline()
                    out["invcovars"] = inv
                else:
                    line = f.readline()
        return out
    return _cached(path, _parse)


def parse_extractor_file(path: str) -> dict:
    """Returns dict(extractor_matrix (C,D,IV), sigma_inv (C,D,D), offset)."""
    def _parse(path):
        out = {}
        num_gaussian = None
        with open(path) as f:
            line = f.readline()
            while line:
                if "<w_vec>" in line:
                    num_gaussian = len(line.split()[2:-1])
                    line = f.readline()
                elif "<M>" in line:
                    mats = []
                    for _ in range(num_gaussian):
                        line = f.readline()
                        rows = []
                        while "]" not in line:
                            rows.append(_floats(line.split()))
                            line = f.readline()
                        rows.append(_floats(line.split()[:-1]))
                        line = f.readline()
                        mats.append(np.stack(rows))
                    out["extractor_matrix"] = np.stack(mats)
                elif "<SigmaInv>" in line:
                    c, d, _ = out["extractor_matrix"].shape
                    sig = np.zeros((c, d, d))
                    for i in range(num_gaussian):
                        line = f.readline()
                        for j in range(d):
                            vals = _floats(line.split()[:j + 1])
                            sig[i, j, :j + 1] = vals
                            sig[i, :j + 1, j] = vals
                            line = f.readline()
                    out["sigma_inv"] = sig
                elif "<IvectorOffset>" in line:
                    out["offset"] = np.array(float(line.split()[1]))
                    line = f.readline()
                else:
                    line = f.readline()
        return out
    return _cached(path, _parse)


def parse_plda_file(path: str) -> dict:
    """Returns dict(mean (D,), transform (D,D), psi (D,))."""
    def _parse(path):
        with open(path) as f:
            line = f.readline()
            mean = _floats(line.split()[2:-1])
            d = len(mean)
            f.readline()  # row of markup
            line = f.readline()
            rows = []
            for _ in range(d):
                rows.append(_floats(line.split(" ")[2:-1])[:d])
                line = f.readline()
            psi = _floats(line.split()[1:-1])[:d]
        return {"mean": mean, "transform": np.stack(rows), "psi": psi}
    return _cached(path, _parse)


def parse_mean_file(path: str) -> np.ndarray:
    """Global embedding mean (reference model/utils.py:50-60)."""
    with open(path) as f:
        line = f.readline()
    return _floats(line.split()[1:-1])


def parse_transform_mat_file(path: str) -> np.ndarray:
    """LDA transform matrix (reference model/utils.py:63-80)."""
    with open(path) as f:
        lines = f.readlines()[1:]
    rows = []
    for i, line in enumerate(lines):
        body = line[:-1] if i < len(lines) - 1 else line[:-2]
        rows.append(_floats(body.strip().split(" ")))
    return np.stack(rows)


def parse_enroll_model_file(path: str):
    """Enrolled-speaker index: returns (num_spks, spk_ids, z_norm_means,
    z_norm_stds, enroll_embs) — embeddings loaded from per-speaker .npy
    files (the torch.save paths of the reference become .npy here)."""
    info = np.loadtxt(path, dtype=str, comments=None)
    if info.ndim == 1:
        info = info[None, :]
    spk_ids = list(info[:, 0])
    emb_paths = list(info[:, 1])
    z_means = info[:, 2].astype(np.float32)
    z_stds = info[:, 3].astype(np.float32)
    embs = np.concatenate([np.load(p).reshape(1, -1) for p in emb_paths], 0)
    return len(spk_ids), spk_ids, z_means, z_stds, embs


def parse_mean_file_2(path):
    """Pickled (1, emb_dim) mean used by other models
    (reference model/utils.py:84-91); returns 0 when path is None."""
    if path is None:
        return 0
    import pickle
    with open(path, "rb") as f:
        mean = pickle.load(f)
    return np.asarray(mean).reshape(-1)


def write_label_encoder(path: str, spk_ids):
    """Write the audionet label-encoder txt ('spk_id' label rows,
    reference label-encoder-audionet-Spk251_test.txt format)."""
    with open(path, "w") as f:
        for i, sid in enumerate(spk_ids):
            f.write(f"'{sid}' {i}\n")


def write_enroll_model_file(path: str, spk_ids, emb_paths, z_means, z_stds):
    with open(path, "w") as f:
        for sid, ep, zm, zs in zip(spk_ids, emb_paths, z_means, z_stds):
            f.write(f"{sid} {ep} {zm} {zs}\n")
