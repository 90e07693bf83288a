"""Speaker datasets and the host-side batched loader that feeds the trainer.

Port of speakerguard_tpu/data/dataset.py (reference dataset/Dataset.py):
walks root/name/<spk_id>/<utt>.wav, label = index into spk_ids else -1
(imposter), optional int16-domain scaling (normalize=False), random crop or
zero pad to wav_length for static shapes.  Batches are numpy arrays; with
the same seed they are the JAX package's batches, in the same order: the
crop starts come from the dataset's own ``default_rng(seed)``, the shuffle
first, then one start per file.  The native loader (``utils/native.py``)
draws a batch's starts before it can fail; when it fails, the scipy path
draws again, as the JAX package does.  ``loader_counts`` records how
many batches each loader served.

The five named datasets (Spk10_enroll/test/imposter, Spk251_train/test) pin
normalize/bits exactly like the reference one-liner subclasses.  The
download code is the JAX package's (it needs the network; the Dataset
constructor tries it only when SPEAKERGUARD_DOWNLOAD=1), so absent
datasets raise with instructions.
"""

import os

import numpy as np

from speakerguard_tpu_torch.utils import native
from speakerguard_tpu_torch.utils.audio_io import read_wav

_GDRIVE_IDS = {
    "Spk10_enroll": "1BBAo64JOahk0F3yBAovnRLZ1NvjwBy7y",
    "Spk10_test": "1WctqJtP5Es74-U7y3cFXqfHi7JkDz6g5",
    "Spk10_imposter": "1f1GULs0aj_Xrw8JRxe6zzvTN3r2nnOf6",
    "Spk251_train": "1iGcMPiPMzcCLI7xKJLwH1L0Ff_95-tmB",
    "Spk251_test": "1rsXzuEyi5Zqd1XAsr1_Op7mC7hqY0tsp",
}


def gdrive_download(file_id: str, dest_path: str, opener=None) -> str:
    """gdown-equivalent Google Drive fetch (reference Dataset.py:40-48 uses
    gdown).  Large files are served an HTML interstitial instead of the
    payload; this follows the confirm flow like gdown does:

      1. GET drive.google.com/uc?id=...&export=download
      2. if the response is HTML, extract either the modern
         drive.usercontent.google.com form (hidden inputs incl. uuid) or
         the legacy download_warning cookie / confirm= token
      3. re-request with the confirmation attached

    `opener` is injectable for tests (a urllib-style object with
    .open(url) -> response having .headers/.read())."""
    import re
    import shutil
    import urllib.parse
    import urllib.request
    import http.cookiejar

    if opener is None:
        cj = http.cookiejar.CookieJar()
        opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(cj))
    else:
        cj = []

    def save(resp):
        with open(dest_path, "wb") as f:
            shutil.copyfileobj(resp, f)
        return dest_path

    url = (f"https://drive.google.com/uc?id={file_id}&export=download")
    with opener.open(url) as resp:
        if "text/html" not in resp.headers.get("Content-Type", ""):
            return save(resp)
        html = resp.read().decode("utf-8", "replace")

    # modern form: action="https://drive.usercontent.google.com/download"
    # with hidden <input name=... value=...> fields (id/export/confirm/uuid)
    action = re.search(r'<form[^>]+action="([^"]+)"', html)
    fields = dict(re.findall(r'<input[^>]+name="([^"]+)"[^>]+value="([^"]*)"',
                             html))
    if action and fields.get("id"):
        confirm_url = f"{action.group(1)}?{urllib.parse.urlencode(fields)}"
    else:
        # legacy confirm token: download_warning cookie or confirm= link
        token = next((c.value for c in cj
                      if c.name.startswith("download_warning")), None)
        if token is None:
            m = re.search(r"confirm=([0-9A-Za-z_-]+)", html)
            token = m.group(1) if m else "t"
        confirm_url = url + f"&confirm={token}"
    with opener.open(confirm_url) as resp:
        ct = resp.headers.get("Content-Type", "")
        if "text/html" in ct:
            raise RuntimeError(
                f"Google Drive still returned HTML for {file_id}; the file "
                "may be rate-limited or the quota exceeded — download "
                "manually with gdown and untar into the dataset root")
        return save(resp)


def download_dataset(name: str, dest_dir: str) -> str:
    """Auto-download + untar a named dataset (reference Dataset.py:40-48).
    Requires network; callers opt in (the Dataset constructor attempts it
    only when SPEAKERGUARD_DOWNLOAD=1, since most deployments are airgapped
    and prefer the actionable FileNotFoundError)."""
    import tarfile
    if name not in _GDRIVE_IDS:
        raise NotImplementedError(f"No download url for {name}")
    os.makedirs(dest_dir, exist_ok=True)
    tar_path = os.path.join(dest_dir, f"{name}.tar.gz")
    gdrive_download(_GDRIVE_IDS[name], tar_path)
    with tarfile.open(tar_path, "r:gz") as tf:
        tf.extractall(dest_dir, filter="data")
    return os.path.join(dest_dir, name)


class Dataset:

    def __init__(self, spk_ids, root, name, normalize=False, bits=16,
                 return_file_name=False, wav_length=None, seed=0):
        self.spk_ids = list(spk_ids)
        self.root = os.path.join(root, name)
        if not os.path.exists(self.root) and name in _GDRIVE_IDS \
                and os.environ.get("SPEAKERGUARD_DOWNLOAD") == "1":
            download_dataset(name, root)
        if not os.path.exists(self.root):
            hint = ""
            if name in _GDRIVE_IDS:
                hint = (f"; set SPEAKERGUARD_DOWNLOAD=1 to auto-download, or "
                        f"run: gdown 'https://drive.google.com/uc?id="
                        f"{_GDRIVE_IDS[name]}&export=download' && "
                        f"tar -xzf {name}.tar.gz")
            raise FileNotFoundError(f"dataset {self.root} not found{hint}")
        self.audio_paths = []
        for spk_id in sorted(os.listdir(self.root)):
            spk_dir = os.path.join(self.root, spk_id)
            if not os.path.isdir(spk_dir):
                continue
            for audio_name in sorted(os.listdir(spk_dir)):
                if audio_name.endswith(".wav"):
                    self.audio_paths.append((spk_id, audio_name))
        self.normalize = normalize
        # Declared audio domain of every yielded batch: "scale" = floats in
        # [-1, 1); "origin" = int16-valued floats.  Consumers branch on this
        # tag instead of guessing from amplitudes (reference model/utils.py:7
        # heuristic stays only at the model boundary).
        self.domain = "scale" if normalize else "origin"
        self.bits = bits
        self.return_file_name = return_file_name
        self.wav_length = wav_length
        self._rng = np.random.default_rng(seed)
        # how many batches each loader served
        self.loader_counts = {"native": 0, "scipy": 0}

    def __len__(self):
        return len(self.audio_paths)

    def __getitem__(self, idx):
        spk_id, audio_name = self.audio_paths[idx]
        label = (self.spk_ids.index(spk_id) if spk_id in self.spk_ids
                 else -1)
        path = os.path.join(self.root, spk_id, audio_name)
        audio = read_wav(path)  # float32 in [-1, 1), (L,)
        if not self.normalize:
            audio = audio * (2.0 ** (self.bits - 1))
        if self.wav_length:
            n = len(audio)
            if self.wav_length < n:
                start = self._rng.integers(0, n - self.wav_length + 1)
                audio = audio[start:start + self.wav_length]
            elif self.wav_length > n:
                audio = np.pad(audio, (0, self.wav_length - n))
        audio = audio[None, :]  # (1, L) mono channel, like the reference
        if self.return_file_name:
            return audio, label, os.path.splitext(audio_name)[0]
        return audio, label

    def _native_batch(self, idxs):
        """Fast path: the C++ threaded WAV decoder (native/wavloader.cpp);
        returns (B, 1, L) or None to fall back."""
        if native.get_lib() is None or not self.wav_length:
            return None
        paths, starts = [], []
        for i in idxs:
            spk_id, audio_name = self.audio_paths[i]
            path = os.path.join(self.root, spk_id, audio_name)
            n = native.wav_num_samples(path)
            if n is None:
                return None
            start = (self._rng.integers(0, n - self.wav_length + 1)
                     if n > self.wav_length else 0)
            paths.append(path)
            starts.append(start)
        scale = 1.0 if self.normalize else float(2 ** (self.bits - 1))
        out = native.load_wav_batch(paths, self.wav_length, starts,
                                    scale=scale)
        return None if out is None else out[:, None, :]

    def batches(self, batch_size, shuffle=False, drop_last=False,
                use_native=True):
        """Yield (wavs (B, 1, L), labels (B,)[, names]) numpy batches.
        Requires wav_length (static shapes) when batch_size > 1."""
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), batch_size):
            idxs = order[s:s + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            wavs = self._native_batch(idxs) if use_native else None
            loader = "native"
            if wavs is None:
                items = [self[i] for i in idxs]
                wavs = np.stack([it[0] for it in items]).astype(np.float32)
                loader = "scipy"
            self.loader_counts[loader] += 1
            labels = np.array(
                [self.spk_ids.index(self.audio_paths[i][0])
                 if self.audio_paths[i][0] in self.spk_ids else -1
                 for i in idxs], np.int64)
            if self.return_file_name:
                names = [os.path.splitext(self.audio_paths[i][1])[0]
                         for i in idxs]
                yield wavs, labels, names
            else:
                yield wavs, labels


def _named(name, normalize, bits=16):
    class _D(Dataset):
        def __init__(self, spk_ids, root="./data", return_file_name=False,
                     wav_length=None, seed=0):
            super().__init__(spk_ids, root, name, normalize=normalize,
                             bits=bits, return_file_name=return_file_name,
                             wav_length=wav_length, seed=seed)
    _D.__name__ = name
    return _D


Spk10_enroll = _named("Spk10_enroll", normalize=False)
Spk10_test = _named("Spk10_test", normalize=False)
Spk10_imposter = _named("Spk10_imposter", normalize=False)
Spk251_train = _named("Spk251_train", normalize=True)
Spk251_test = _named("Spk251_test", normalize=True)
