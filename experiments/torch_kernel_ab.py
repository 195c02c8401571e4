"""Time the PyTorch port's CUDA kernels for one or more trees, in turns.

    python3 experiments/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (or an unpacked ``git archive``) holding
``chip_smoke.py`` and ``fall_multimodal_tpu_torch/`` whose kernel wrappers
take packs (``pack_block``, ``pack_backbone``); name a root several times to
alternate (parent, change, change, parent). Every root is timed in
a process of its own, on the same card, with the seeded weights and inputs
of its ``chip_smoke.py``:

* the STGCAN-block kernel at the flagship's 14 block shapes, batch 128 and
  batch 1 (the sum is the kernel's time per flagship forward);
* the whole-backbone kernel on ``default_urfall`` at batch 128 and batch 1,
  beside the same backbone in seven block launches;
* the batch-1 streaming push (``StreamingClassifier.push``, host clock with
  the card synchronised, as ``chip_smoke.py`` takes it) of the flagship and
  of ``default_urfall``: p50 over 50 pushes.

Prints one line per root: registers and spills of a fresh build, then CUDA
event times in ms. Needs an NVIDIA GPU and ``nvcc``; imports no JAX.
"""

import os
import subprocess
import sys


def time_tree(root: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from fall_multimodal_tpu_torch.ops import build
    from fall_multimodal_tpu_torch.ops.fused_backbone import FusedBackbone
    from fall_multimodal_tpu_torch.ops.stgcan_block import fused_stgcan_block

    built = build.build_all()
    info = "; ".join(
        f"{name}: " + ", ".join(part.strip() for line in rep["log"].splitlines()
                                for part in line.split(",")
                                if "registers" in part or "spill" in part)
        for name, rep in sorted(built.items())) or "cached build"
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    cfg = cs.load_config(cs.preset_path("gstcan_urfall_3stream"))
    pred = cs.Predictor(cfg, cs.seeded_state_dict(cfg), batch_size=128, device=dev)
    k1 = {128: 0.0, 1: 0.0}
    for _, _, t, packed, stride, _ in cs.block_shapes(pred):
        x = torch.from_numpy(rng.normal(size=(128, t, 14, packed.cin)).astype(np.float32)).to(dev)
        for n in k1:
            xn = x[:n].contiguous()
            k1[n] += cs.cuda_ms(lambda: fused_stgcan_block(xn, packed, stride),
                                iters=30, warmup=5)
    line = (f"{root}: [{info}] block kernel {k1[128]:.4f} ms per flagship forward "
            f"(batch 1: {k1[1]:.4f} ms)")

    def push_p50(predictor, d, sensor_dim):
        lat = cs.measure_push_latency(cs.StreamingClassifier(predictor, seq_len=d.seq_len),
                                      n_pushes=50, warmup=5, sensor_dim=sensor_dim)
        return lat["p50_ms"]

    line += f"; flagship push p50 {push_p50(pred, cfg.data, cfg.data.sensor_dim):.3f} ms"

    from fall_multimodal_tpu_torch.ops.fused_backbone_v2 import (
        fold_backbone,
        fused_backbone_forward,
        pack_backbone,
    )

    cfg = cs.load_config(cs.preset_path("default_urfall"))
    pred = cs.Predictor(cfg, cs.seeded_state_dict(cfg), batch_size=128, device=dev)
    whole_pack = pack_backbone(fold_backbone(pred.model), dev)
    blockwise = FusedBackbone(pred.model)
    x = torch.from_numpy(rng.normal(size=(128, 30, 14, 3)).astype(np.float32)).to(dev)
    for name, xs in (("N=128", x), ("N=1", x[:1].contiguous())):
        whole = cs.cuda_ms(lambda: fused_backbone_forward(xs, whole_pack), iters=30, warmup=5)
        seven = cs.cuda_ms(lambda: blockwise(xs), iters=30, warmup=5)
        line += f"; backbone {name}: one launch {whole:.4f} ms, seven launches {seven:.4f} ms"
    line += f"; stgcan push p50 {push_p50(pred, cfg.data, None):.3f} ms"
    print(line, flush=True)


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        time_tree(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root])
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
