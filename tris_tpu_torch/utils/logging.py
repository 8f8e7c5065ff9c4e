"""Logger + scalar metrics writer.

Re-design of `reference/logger.py` (rank-0 stdout logger) and the
tensorboardX scalar stream (`train_stage1.py:376-385`): scalars go to a JSONL
file (always — trivially machine-readable) and to TensorBoard event files
when a writer backend is importable, so users with TB dashboards keep them.
Backends are tried lightest-first: ``tensorboardX`` (the reference's own
choice), ``torch.utils.tensorboard``, then ``tf.summary`` (a TensorFlow
import costs ~13 s, so it is the last resort).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import sys
import time
from typing import Optional


@functools.lru_cache()
def create_logger(dist_rank: int = 0, name: str = "tris") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if dist_rank == 0 and not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        ))
        logger.addHandler(handler)
    return logger


def _make_tb_writer(log_dir: str):
    """(add_scalar, flush, close) triple from the lightest importable
    TensorBoard backend, or None. Gate with TRIS_TENSORBOARD=0."""
    if os.environ.get("TRIS_TENSORBOARD", "1") == "0":
        return None
    try:
        from tensorboardX import SummaryWriter  # the reference's backend

        w = SummaryWriter(logdir=log_dir)
        return w.add_scalar, w.flush, w.close
    except Exception:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        w = SummaryWriter(log_dir=log_dir)
        return w.add_scalar, w.flush, w.close
    except Exception:
        pass
    try:
        import tensorflow as tf

        w = tf.summary.create_file_writer(log_dir)

        def add_scalar(tag, value, step):
            with w.as_default():
                tf.summary.scalar(tag, value, step=step)

        return add_scalar, w.flush, w.close
    except Exception:
        return None


class MetricsWriter:
    """Scalar writer: JSONL always; TensorBoard event files if a backend is
    importable (see _make_tb_writer)."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            self._tb = _make_tb_writer(log_dir)

    def scalar(self, tag: str, value: float, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
            ) + "\n")
        if self._tb is not None:
            self._tb[0](tag, float(value), int(step))

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb[1]()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb[1]()
            self._tb[2]()
