"""Hash-table constants (counterpart of ``dpu_olap_tpu/ops/hashtable.py``).

Only the EMPTY sentinel is ported so far; the sorted-store and cuckoo tables
follow (ROADMAP §1 item 8).
"""

import numpy as np

# Reserved key: the EMPTY slot marker and the sort pad key. Real keys equal
# to it are outside the fast paths' contract.
EMPTY = np.uint32(0xFFFFFFFF)
