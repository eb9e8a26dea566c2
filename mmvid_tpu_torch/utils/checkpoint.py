"""Checkpoint save/load: run directories in the reference's own format.

The counterpart of ``mmvid_tpu/utils/checkpoint.py``, whose orbax
directories need JAX: here every checkpoint is the reference's
``dalle.pt`` (utils/utils_train.py:297-305), written with ``torch.save``
under the reference's layout, ``<log_dir>/weights/<iter>/dalle.pt`` and
``<log_dir>/weights/last/dalle.pt`` (train.py:341-354).  A file holds
``{iter, hparams, vae_params, weights}``, as
``mmvid_tpu/utils/torch_compat.py::save_dalle_checkpoint`` writes them
(``weights``: the reference state_dict, fp32, the VQGANs' included), plus
``opt_state`` (``training.opt_state_leaves``) and ``step`` for a resume.
Test-time discovery picks the numerically-latest iter like the
reference's natsort (test.py:51-57).  Reading JAX's orbax directories is
not ported (ROADMAP.md).
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

FILE = 'dalle.pt'


def _ckpt_dir(log_dir: str, tag) -> str:
    return os.path.join(log_dir, 'weights', str(tag))


def _write(path: str, payload: Dict[str, Any]) -> None:
    """torch.save into ``path`` by way of a temporary file, so a reader
    never sees half a checkpoint."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_file(log_dir: str, step, payload: Dict[str, Any], name: str,
              keep_last: bool = True) -> str:
    """Write weights/<step>/<name> and refresh weights/last/<name>;
    returns the file written under ``step``."""
    path = os.path.join(os.path.abspath(_ckpt_dir(log_dir, step)), name)
    _write(path, payload)
    if keep_last:
        last = os.path.join(os.path.abspath(_ckpt_dir(log_dir, 'last')),
                            name)
        os.makedirs(os.path.dirname(last), exist_ok=True)
        shutil.copyfile(path, last + '.tmp')
        os.replace(last + '.tmp', last)
    return path


def save_checkpoint(log_dir: str, step, tree: Dict[str, Any],
                    hparams: Optional[Dict] = None, keep_last: bool = True
                    ) -> str:
    """Write weights/<step>/dalle.pt and refresh weights/last/dalle.pt.
    ``tree``: {'step', 'weights'[, 'opt_state']}, tensors on the host.
    Returns the file written under ``step``."""
    payload = {'iter': int(tree['step']), 'hparams': dict(hparams or {}),
               'vae_params': None, **tree}
    return save_file(log_dir, step, payload, FILE, keep_last)


def _numeric_iters(root: str):
    """Numeric weights/<iter> dir names — the single definition both
    resume discovery and retention pruning agree on."""
    if not os.path.isdir(root):
        return []
    return sorted((d for d in os.listdir(root)
                   if re.fullmatch(r'\d+', d)), key=int)


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """Numerically-latest weights/<iter>/ (reference natsort,
    test.py:51-57), else weights/last/, else None."""
    iters = _numeric_iters(os.path.join(log_dir, 'weights'))
    if iters:
        return _ckpt_dir(log_dir, iters[-1])
    if os.path.isdir(_ckpt_dir(log_dir, 'last')):
        return _ckpt_dir(log_dir, 'last')
    return None


def checkpoint_file(path: str) -> str:
    """The ``dalle.pt`` that ``path`` names: the file itself, a checkpoint
    directory holding one, or a run directory (its latest checkpoint)."""
    if os.path.isfile(path):
        return path
    if os.path.isfile(os.path.join(path, FILE)):
        return os.path.join(path, FILE)
    latest = latest_checkpoint(path)
    if latest is not None and os.path.isfile(os.path.join(latest, FILE)):
        return os.path.join(latest, FILE)
    raise FileNotFoundError(f'no {FILE} at {path} (a file, a checkpoint '
                            'directory or a run directory)')


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """(the checkpoint's dict, its hparams) from a ``dalle.pt`` or a
    directory (:func:`checkpoint_file`)."""
    obj = torch.load(checkpoint_file(path), map_location='cpu',
                     weights_only=False)
    return obj, obj.get('hparams') or {}


class AsyncCheckpointWriter:
    """Overlap checkpoint writes with training (beyond-parity; the
    reference's torch.save blocks the loop, utils_train.py:297-305).

    The caller still does the device->host transfer (building the tree);
    the file write runs on one worker thread.  ``submit`` first joins any
    in-flight write, so at most one checkpoint is buffered in host RAM and
    ``weights/last`` is never written concurrently.  Call ``wait()``
    before any synchronous save and at shutdown; a worker exception
    surfaces on the next submit()/wait().
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(1, 'ckpt-writer')
        self._inflight = None

    def submit(self, log_dir: str, step, tree: Dict[str, Any], **kwargs):
        self.wait()
        # the directory exists before submit returns, so a prune right
        # after it counts this checkpoint among the newest
        os.makedirs(_ckpt_dir(log_dir, step), exist_ok=True)
        self._inflight = self._pool.submit(save_checkpoint, log_dir, step,
                                           tree, **kwargs)

    def wait(self):
        if self._inflight is not None:
            f, self._inflight = self._inflight, None
            f.result()

    def close(self):
        self.wait()
        self._pool.shutdown()


def prune_checkpoints(log_dir: str, keep_n: int):
    """Delete all but the newest ``keep_n`` NUMERIC weights/<iter> dirs
    (beyond-parity; the reference keeps every periodic save).  'last',
    'preempt_at_*', and 'nan_at_*' are never pruned.  No-op for
    keep_n <= 0 (reference behavior: keep everything)."""
    if keep_n <= 0:
        return
    root = os.path.join(log_dir, 'weights')
    for d in _numeric_iters(root)[:-keep_n]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
