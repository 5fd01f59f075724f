"""Synthetic stereo scenes for the port.

The reference package's ``make_batch`` needs only numpy; it is re-exported
here so that users of the port import only ``coponerf_tpu_torch``.  Move its
numpy batch to a device with ``models.batch_to_torch``.
"""

from coponerf_tpu.data.synthetic import make_batch

__all__ = ["make_batch"]
