"""The fused bottleneck kernel alone on the card: chip_smoke.py's phase a
(the kernel against its plain version at the R50 stage shapes of batch 32 and
at ragged shapes, the launch configurations, the gradient) and the per-stage
times of its phase f, without the rest of that script; then where a CTA's
time goes, from the kernel's phase trace (``bottleneck_phase_trace``): the mean time of a CTA in conv1,
conv2's wgmma, conv2's epilogue and conv3 (its epilogues apart), the share
of a CTA spent waiting for weight slots, and how many CTAs ran at once.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_bottleneck_stages.py

It builds ``csrc/bottleneck.cu`` if needed and prints the card's name and
power limit first. Exits non-zero on any disagreement.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bottleneck_stages: needs a CUDA card", file=sys.stderr)
        return 2
    from pytorch_retinanet_tpu_torch.kernels import (
        BOTTLENECK_TRACE_FIELDS, KERNELS, bottleneck_phase_trace, bottleneck_plain, fused_bottleneck,
    )
    from pytorch_retinanet_tpu_torch.kernels.build import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build(["bottleneck"])
    dev = torch.device("cuda")
    results = {k.name: {} for k in KERNELS}
    stage_args = chip_smoke.check_bottleneck_kernel(dev, results, fused_bottleneck, bottleneck_plain)
    tot = chip_smoke.time_bottleneck_stages(dev, stage_args, fused_bottleneck, bottleneck_plain)
    chip_smoke.log(f"[time] the 10 blocks of one forward: kernel {tot['ms']:.4f} ms, plain "
                   f"{tot['plain_ms']:.4f}, cuDNN Bottleneck module {tot['library_ms']:.4f}, bound "
                   f"{tot['bound_ms']:.4f} ms; {smi}")
    for (h, w, mid, _), args in zip(chip_smoke.BOTTLENECK_STAGES, stage_args):
        bottleneck_phase_trace(*args)  # warm
        tr = bottleneck_phase_trace(*args).double()
        f = {k: tr[:, i] for i, k in enumerate(BOTTLENECK_TRACE_FIELDS)}
        us = {"CTA": (f["end_ns"] - f["start_ns"]) / 1e3,
              "conv1": (f["conv1_done_ns"] - f["start_ns"]) / 1e3,
              "conv1 epilogues": f["conv1_epilogue_ns"] / 1e3,
              "conv2 wgmma": (f["conv2_wgmma_done_ns"] - f["conv1_done_ns"]) / 1e3,
              "conv2 epilogue": (f["y2_written_ns"] - f["conv2_wgmma_done_ns"]) / 1e3,
              "conv3": (f["end_ns"] - f["y2_written_ns"]) / 1e3,
              "conv3 epilogues": f["conv3_epilogue_ns"] / 1e3}
        span = (f["end_ns"].max() - f["start_ns"].min()) / 1e6
        busy = (f["end_ns"] - f["start_ns"]).sum() / 1e6
        wait = (f"; waiting for weight slots {f['full_wait_cycles'].sum() / f['cycles'].sum():.3f} "
                f"of a CTA's cycles ({f['conv1_full_wait_cycles'].sum() / f['cycles'].sum():.3f} in "
                f"conv1)")
        chip_smoke.log(
            f"[trace] bottleneck [{chip_smoke.BATCH}, {h}, {w}, {4 * mid}] mid {mid}: {len(tr)} CTAs "
            f"on {int(f['sm'].unique().numel())} SMs over {span:.4f} ms, {busy / span:.1f} CTAs at "
            f"once on average; mean us per CTA: "
            + ", ".join(f"{k} {v.mean():.2f}" for k, v in us.items()) + wait + f"; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
