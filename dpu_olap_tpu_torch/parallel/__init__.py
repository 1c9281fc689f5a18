"""Device runtime (counterpart of ``dpu_olap_tpu/parallel``): DeviceSet over
one or several torch devices in ``mesh``, the operators' round loop in
``streaming``, the shuffle and its exchange across devices (``shuffle``),
the shuffle join (``dist_join``), the two-level mesh and its hierarchical
shuffle (``multihost``), the partition engines (``partitioner``) and one
process a device, the ranks of a process group (``process_group``)."""
