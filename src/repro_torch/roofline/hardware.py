"""NVIDIA H100 constants for the roofline and the kernels' bounds.

One entry per variant, from NVIDIA's H100 Tensor Core GPU data sheet
(dense rates, no sparsity) unless a line says otherwise:

  bf16_flops  dense BF16 tensor-core FLOP/s: SXM 989 T, PCIe 756 T
  hbm_bw      HBM bytes/s: SXM 3.35 TB/s (HBM3), PCIe 2.0 TB/s (HBM2e)
  hbm_bytes   device memory: 80 GB on both (counted as 80e9 bytes)
  fp32_ops    non-tensor FP32 op/s: SXM 67 T, PCIe 51 T (the kernels'
              bounds use it for attention's fp32 ops and for integer ops)
  nvlink_bw   NVLink bytes/s a GPU sends one way: SXM 900 GB/s
              bidirectional (fourth-generation NVLink), PCIe 600 GB/s
              through the NVLink bridge; a ring collective sends one way,
              so half of each
  net_bw      bytes/s a GPU sends to another node: one 400 Gb/s NDR
              InfiniBand NIC a GPU (DGX H100: 8 ConnectX-7 for 8 GPUs),
              the line rate; no ring beats it across nodes
  gpus_per_node  GPUs on one NVLink domain (DGX / HGX H100: 8)

``variant(name)`` picks the entry by a card's name
(``torch.cuda.get_device_name``); ``PLANNED`` names the one the dry-run's
production meshes are planned on.  The reference's TPU v5e constants stay
in ``repro/roofline/hardware.py``; nothing here is a TPU number.
"""
from __future__ import annotations

H100 = {
    "H100 SXM": dict(bf16_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
                     fp32_ops=67e12, nvlink_bw=900e9 / 2, net_bw=400e9 / 8,
                     gpus_per_node=8),
    "H100 PCIe": dict(bf16_flops=756e12, hbm_bw=2.0e12, hbm_bytes=80e9,
                      fp32_ops=51e12, nvlink_bw=600e9 / 2, net_bw=400e9 / 8,
                      gpus_per_node=8),
}
#: the variant of the production meshes the dry-run and the roofline plan
PLANNED = "H100 SXM"


def variant(name: str) -> str:
    """The ``H100`` key of a card by its name ("... PCIe" or else SXM)."""
    return "H100 PCIe" if "PCIe" in name else "H100 SXM"

