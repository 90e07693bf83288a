"""The data-parallel input pipeline: each rank loads only its rows of every
global batch.

Port of speakerguard_tpu/parallel/input.py.  Where JAX assembles one
global array from the processes' slices
(``make_array_from_process_local_data``), a rank here keeps its rows as a
tensor on its own device (``make_global_batch``): the sharded steps of
``parallel/mesh.py`` take exactly that.  ``host_sharded_batches`` yields
the rows on the host, so that ``prefetch``'s thread can load them, and
the caller puts them on the rank's device in its own thread.  One
process (no mesh) is the degenerate case: its rows are the whole batch.
"""

import os

import numpy as np
import torch

from speakerguard_tpu_torch.parallel.mesh import axis_info
from speakerguard_tpu_torch.utils import native
from speakerguard_tpu_torch.utils.audio_io import read_wav


def prefetch(iterator, size: int = 2):
    """Overlaps host-side batch loading with device compute: a daemon thread
    keeps up to ``size`` items queued ahead of the consumer (double
    buffering).  The items come out in order; the producer's exception is
    raised again at the consumer's next pull."""
    import queue
    import threading

    q = queue.Queue(maxsize=size)
    _end = object()

    def producer():
        try:
            for item in iterator:
                q.put((None, item))
        except BaseException as exc:  # noqa: BLE001 - raised at consumer
            q.put((exc, None))
            return
        q.put((_end, None))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        exc, item = q.get()
        if exc is _end:
            return
        if exc is not None:
            raise exc
        yield item


def make_global_batch(local, device):
    """This rank's rows (``local``, a numpy batch whose leading axis is the
    rank's slice of the global batch) as a tensor on ``device``, the
    rank's (``parallel.mesh.rank_device``).  Keeps JAX's name; nothing is
    assembled across ranks."""
    return torch.from_numpy(np.ascontiguousarray(local)).to(device)


def _num_samples(path):
    n = native.wav_num_samples(path)
    return len(read_wav(path)) if n is None else n


def _crop_starts(dataset, idxs):
    """The crop start of every wave of a global batch, drawn from
    ``dataset._rng`` in the batch's order as ``Dataset`` draws them (one
    draw for each wave longer than ``wav_length``): every rank draws all of
    them, so the streams stay alike and each rank's crops are the global
    batch's."""
    length = dataset.wav_length
    starts = []
    for i in idxs:
        spk_id, name = dataset.audio_paths[i]
        n = _num_samples(os.path.join(dataset.root, spk_id, name))
        starts.append(int(dataset._rng.integers(0, n - length + 1))
                      if length and n > length else 0)
    return starts


def _load_rows(dataset, idxs, starts, use_native):
    """(rows, 1, L) float32 waves of ``idxs`` cropped at ``starts`` (zero
    padded when short), in the dataset's domain."""
    paths = [os.path.join(dataset.root, *dataset.audio_paths[i])
             for i in idxs]
    scale = 1.0 if dataset.normalize else float(2 ** (dataset.bits - 1))
    length = dataset.wav_length
    wavs = None
    if use_native and length:
        wavs = native.load_wav_batch(paths, length, starts, scale=scale)
    if wavs is None:
        rows = []
        for path, start in zip(paths, starts):
            audio = read_wav(path) * scale if scale != 1.0 else read_wav(path)
            if length:
                audio = audio[start:start + length]
                audio = np.pad(audio, (0, length - len(audio)))
            rows.append(audio)
        wavs = np.stack(rows).astype(np.float32)
    return wavs[:, None, :]


def host_sharded_batches(dataset, global_batch_size: int, mesh=None,
                         axis: str = "data", shuffle: bool = False,
                         drop_last: bool = True, use_native: bool = True):
    """Yields this rank's (wavs (b, 1, L) float32, labels (b,) int64) numpy
    rows of every global batch of a ``data.dataset.Dataset``, loading only
    its rows (``make_global_batch`` puts them on the rank's device).

    Every rank must build the dataset with the same seed: the shuffle and
    the crop starts come from ``dataset._rng``, drawn for the whole global
    batch on every rank, so the ranks' rows put together are the global
    batch of one process.  Rank i of ``axis`` reads rows [i b, (i+1) b) of
    each global batch, b = global_batch_size / N.  A ragged tail cannot be
    split evenly, so more than one rank requires drop_last."""
    _, index, size = axis_info(mesh, axis)
    if global_batch_size % size:
        raise ValueError("the global batch must divide over the ranks")
    if not drop_last and size > 1:
        raise ValueError("more than one rank requires drop_last")
    local_bs = global_batch_size // size

    order = np.arange(len(dataset))
    if shuffle:
        dataset._rng.shuffle(order)  # same seed everywhere: same order

    n = len(order)
    for s in range(0, n, global_batch_size):
        idxs = order[s:s + global_batch_size]
        if len(idxs) < global_batch_size:
            if drop_last:
                break
            local = slice(None)  # one process: keep the ragged tail
        else:
            local = slice(index * local_bs, (index + 1) * local_bs)
        starts = _crop_starts(dataset, idxs)
        wavs = _load_rows(dataset, idxs[local], starts[local], use_native)
        labels = np.array(
            [dataset.spk_ids.index(dataset.audio_paths[i][0])
             if dataset.audio_paths[i][0] in dataset.spk_ids else -1
             for i in idxs[local]], np.int64)
        yield wavs, labels
