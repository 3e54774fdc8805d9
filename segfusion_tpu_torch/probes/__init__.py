"""Hardware probes for the H100: the Pallas probes of ``tools/`` ported.

One module per tool, named after it without the ``probe_`` prefix; each
holds its kernels' wrappers (CUDA in ``csrc/probes.cu``, launch counters)
with a plain PyTorch version beside each, and a ``main(device="cuda")``
that prints what the tool printed, measured on the card:

    python -m segfusion_tpu_torch.probes.<name>

| module          | tool                             | kernels          |
| --------------- | -------------------------------- | ---------------- |
| shadow_variants | tools/probe_shadow_variants.py   | P1               |
| random_access   | tools/probe_random_access.py     | P2, P3, P4, P5   |
| dynamic_gather  | tools/probe_dynamic_gather.py    | P6, P7           |
| pallas_caps3    | tools/probe_pallas_caps3.py      | P11              |
| pallas_caps     | tools/probe_pallas_caps.py       | P8 (7 bodies)    |
| pallas_caps2    | tools/probe_pallas_caps2.py      | P9 (4), P10      |
| shadow_debug    | tools/probe_shadow_debug.py      | P12 (and K2)     |

On the CPU (``main(device="cpu")``) the plain versions run and no time is
printed.
"""
