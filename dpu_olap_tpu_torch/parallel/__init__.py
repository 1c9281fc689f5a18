"""Device runtime (counterpart of ``dpu_olap_tpu/parallel``): DeviceSet over
one torch device in ``mesh``, the operators' round loop in ``streaming``,
the one-device shuffle (``shuffle``), the shuffle join (``dist_join``) and
the partition engines (``partitioner``). The exchange across several
devices is in ROADMAP §1, "Multi-device"."""
