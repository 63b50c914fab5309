"""ExtremeNet -> CenterNet hourglass checkpoint key remap, the hourglass's
pretrained init path (the JAX package's tools/hourglass_weights.py).

Behavioral reference: src/tools/convert_hourglass_weight.py:10-30 — renames
ExtremeNet head keys (t/l/b/r/ct heats + regrs) to CenterNet head names and
wraps the result as {'epoch': 0, 'state_dict': ...}, which
`weights.load_reference_checkpoint` + `weights.load_weights` read
tolerantly, so the backbone seeds polydet fine-tuning:

    python -m centerpoly_tpu_torch.tools.hourglass_weights in.pkl out.pth
"""
from __future__ import annotations

KEY_MAP = {
    "t_heats": "hm_t", "l_heats": "hm_l", "b_heats": "hm_b",
    "r_heats": "hm_r", "ct_heats": "hm_c",
    "t_regrs": "reg_t", "l_regrs": "reg_l",
    "b_regrs": "reg_b", "r_regrs": "reg_r",
}


def remap_extremenet_keys(state_dict: dict) -> dict:
    """Rename ExtremeNet keys; `ct_heats` must not also match `t_heats`."""
    out = {}
    for k, v in state_dict.items():
        new_k = k
        for old, new in KEY_MAP.items():
            if old in k and not ("ct_heats" in k and old == "t_heats"):
                new_k = k.replace(old, new)
                break
        out[new_k] = v
    return out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(
        description="Convert an ExtremeNet .pkl to a loadable .pth")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    sd = torch.load(args.input, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    torch.save({"epoch": 0, "state_dict": remap_extremenet_keys(sd)},
               args.output)
    print(f"wrote {args.output} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
