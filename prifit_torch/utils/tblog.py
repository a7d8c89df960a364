"""TensorBoard scalar logging for the trainer.

The port's copy of ``prifit_tpu/utils/tblog.py``.  The reference logs
per-epoch scalars via ``tensorboard_logger``
(``train_partseg_shapenet.py:170,477-480``); this mirrors that surface
with ``tensorboardX`` event files, or ``torch.utils.tensorboard``'s when
only ``tensorboard`` is installed, alongside the machine-readable
``metrics.jsonl`` each run writes.  With neither it writes nothing and
never raises.
"""

from typing import Optional


class ScalarWriter:
    """``log_value``-style scalar writer backed by tensorboardX or
    ``torch.utils.tensorboard``.

    Args:
        logdir: event-file directory (the run's experiment dir, like the
            reference's ``configure(log_dir)``).  None disables writing.
    """

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if logdir is None:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except Exception:   # tensorboard logging is best-effort
                return
        try:
            self._writer = SummaryWriter(logdir)
        except Exception:
            self._writer = None

    def scalar(self, name: str, value, step: int) -> None:
        """Log one scalar (reference ``log_value(name, value, step)``)."""
        if self._writer is not None:
            self._writer.add_scalar(name, float(value), int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
