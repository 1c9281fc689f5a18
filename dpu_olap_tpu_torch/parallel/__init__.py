"""Device runtime (counterpart of ``dpu_olap_tpu/parallel``): DeviceSet over
one torch device in ``mesh``, the operators' round loop in ``streaming``,
the one-device shuffle (``shuffle``), the shuffle join (``dist_join``) and
the partition engines (``partitioner``). The exchange across several
devices is ROADMAP §1 item 10."""
