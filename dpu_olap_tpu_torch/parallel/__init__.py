"""Device runtime (counterpart of ``dpu_olap_tpu/parallel``): DeviceSet over
one torch device in ``mesh``, the operators' round loop in ``streaming``.
The shuffle and distributed join follow."""
