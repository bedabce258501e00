"""Convert COLMAP sparse models between the binary and text formats.

Counterpart of ``scripts/colmap_converter.py`` (the reference's
``read_model``/``write_model`` over cameras, images and points3D), on the
port's ``data/colmap_io.py``: ids and point tracks are kept, so
.bin → .txt → .bin round-trips losslessly.

    python -m fourdgs_tpu_torch.scripts.colmap_converter --input_model sparse/0 \\
        --output_model sparse_txt --output_format .txt
"""

from __future__ import annotations

import argparse

from fourdgs_tpu_torch.data.colmap_io import read_model_full, write_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Read and write COLMAP binary and text models")
    ap.add_argument("--input_model", required=True)
    ap.add_argument("--input_format", choices=[".bin", ".txt"], default=None,
                    help="autodetected when omitted")
    ap.add_argument("--output_model", required=True)
    ap.add_argument("--output_format", choices=[".bin", ".txt"], default=".txt")
    args = ap.parse_args(argv)

    cams, imgs, pts = read_model_full(args.input_model, args.input_format)
    print(f"read {len(cams)} cameras, {len(imgs)} images, "
          f"{len(pts)} points3D from {args.input_model}")
    write_model(cams, imgs, pts, args.output_model, args.output_format)
    print(f"wrote {args.output_format} model → {args.output_model}")


if __name__ == "__main__":
    main()
