"""NVIDIA H100 SXM constants: the card the port plans for.

Published figures of the H100 SXM5 80 GB at its 700 W power limit (NVIDIA
H100 Tensor Core GPU data sheet), dense (no sparsity).  A card set below
700 W runs slower under load; measured times stand beside the card's name
and power limit, these constants do not change with it.

The reference's names carry over where the meaning does:

- ``PEAK_FLOPS_*``: per card; ``PEAK_FLOPS_F32`` is outside the tensor
  cores (the CUDA cores' FMA rate).
- ``HBM_BW`` / ``HBM_BYTES``: HBM3 rate and capacity per card.
- ``NVLINK_BW``: NVLink 4 to the other cards of a host, per direction.
  It stands where the reference has ``ICI_BW_PER_LINK * ICI_LINKS``: one
  figure for all of a card's links.  On the production meshes a 16-wide
  ``model`` axis spans two 8-card hosts, so part of its traffic crosses
  the slower inter-host network: the one-bandwidth collective term is
  optimistic there.
- ``DCN_BW``: the inter-host network per card.  An assumption: one 400
  Gb/s NIC per card (50 GB/s), the common DGX/HGX H100 layout.
- ``SMEM_PER_SM`` / ``NUM_SMS``: shared memory per SM (228 KB, of which a
  block may use 227 KB) and the SM count, in place of ``VMEM_BYTES``.
"""

PEAK_FLOPS_BF16 = 989e12  # per card, dense bf16 tensor cores
PEAK_FLOPS_INT8 = 1979e12  # dense int8 tensor cores
PEAK_FLOPS_F32 = 67e12  # f32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s per card
HBM_BYTES = 80 * 10**9  # 80 GB per card
NVLINK_BW = 450e9  # bytes/s per card per direction, to the host's other cards
DCN_BW = 50e9  # bytes/s per card across hosts (assumed 400 Gb/s NIC)
SMEM_PER_SM = 228 * 1024  # bytes of shared memory per SM
NUM_SMS = 132

CHIPS_PER_POD = 256  # 16 x 16


def chips(mesh_shape) -> int:
    n = 1
    for s in mesh_shape:
        n *= s
    return n
