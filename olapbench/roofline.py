"""The card's peaks, as NVIDIA's data sheet gives them for an H100 SXM at its
700 W limit; a share of them is stated beside the card's power limit."""

HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
