"""How long a dry-run cell would take to trace, from its variants.

Traces the cell's 0-layer and first one-cycle variants
(``launch.dryrun.variant_configs``) at full width on the production mesh
and extrapolates the whole trace: nonloop + rep x (cycle - nonloop), in
seconds and in ops. For the cells the sweep cannot finish in its time
limit.

    python experiments/torch_dryrun_estimate.py command-r-plus-104b train_4k

Runs on the host (``meta`` tensors); needs no card.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    from repro_torch import configs
    from repro_torch.launch import dryrun

    arch, shape = sys.argv[1], sys.argv[2]
    out = {}
    for tag, vcfg, rep in dryrun.variant_configs(
            configs.get_config(arch))[:2]:
        t0 = time.monotonic()
        rec = dryrun.lower_cell(arch, shape, cfg=vcfg)
        out[tag] = {"s": time.monotonic() - t0, "rep": rep, "ops": rec["ops"],
                    "peak_gb": rec["memory"]["peak_per_device_gb"]}
        print(tag, out[tag], flush=True)
    nl, cyc = out["nonloop"], out["stage0"]
    print(json.dumps({
        "arch": arch, "shape": shape,
        "estimate_s": nl["s"] + cyc["rep"] * (cyc["s"] - nl["s"]),
        "estimate_ops": nl["ops"] + cyc["rep"] * (cyc["ops"] - nl["ops"]),
        **out}))


if __name__ == "__main__":
    main()
