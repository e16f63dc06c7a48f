#!/usr/bin/env python
"""Stage a real capture (folder of image files) into a replayable bundle.

The reference ingests rig captures directly through OpenCV (SURVEY.md C17);
this build's product path reads pre-staged device-ready tensors (.npz
bundles or .sosq streams -- decoding image files per frame inside the
replay loop would stall the device, SURVEY.md section 2.3). This HOST-SIDE tool is the bridge:

    python scripts/stage_sequence.py CAPTURE_DIR out.npz \
        [--gt groundtruth.txt] [--sosq out.sosq] [--size 768]

  - CAPTURE_DIR: directory of .png/.jpg/.jpeg/.bmp/.pgm frames, sorted by
    filename (zero-padded frame numbers recommended).
  - --gt: optional TUM-format trajectory (`t tx ty tz qx qy qz qw`); rows are
    matched to frames by order (row i -> frame i) unless counts differ, in
    which case timestamps are matched nearest-neighbor.
  - --size: center-crop/scale to a square SIZE x SIZE float32 grayscale frame
    (the omnistereo image is square around the mirror axis; 0 = keep as-is,
    requires already-square frames).

PIL/OpenCV are allowed here -- this is tooling that runs once per dataset on
the host, never on the device compute path.

Replay the result:
    python -m sosvo.cli --config configs/c2_chip_ba.json \
        --sequence out.npz [--rig calib.json]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

# Runnable as `python scripts/stage_sequence.py` from anywhere: the sosvo
# package lives in the repo root, one level up from scripts/.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".pgm"}


def load_frame(path: Path, size: int) -> np.ndarray:
    """One image file -> (size, size) float32 grayscale in [0, 1]."""
    from PIL import Image

    im = Image.open(path).convert("L")
    w, h = im.size
    if size:
        side = min(w, h)
        im = im.crop(((w - side) // 2, (h - side) // 2,
                      (w + side) // 2, (h + side) // 2))
        if side != size:
            im = im.resize((size, size), Image.BILINEAR)
    else:
        assert w == h, f"{path.name}: non-square {w}x{h}; pass --size to crop"
    return np.asarray(im, np.float32) / 255.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture_dir")
    ap.add_argument("out", help="output .npz bundle")
    ap.add_argument("--gt", default=None, help="TUM-format ground-truth file")
    ap.add_argument("--sosq", default=None,
                    help="also write a .sosq stream for the native prefetcher")
    ap.add_argument("--size", type=int, default=768,
                    help="square output side (0 = keep original)")
    ap.add_argument("--stride", type=int, default=1, help="take every Nth frame")
    args = ap.parse_args(argv)

    files = sorted(p for p in Path(args.capture_dir).iterdir()
                   if p.suffix.lower() in EXTS)[::args.stride]
    if not files:
        print(f"no image files in {args.capture_dir}", file=sys.stderr)
        return 1
    frames = np.stack([load_frame(p, args.size) for p in files])
    ts = np.arange(len(files), dtype=np.float64)

    poses = None
    if args.gt:
        from sosvo.data.sequence import load_tum_trajectory

        gt_ts, gt_poses = load_tum_trajectory(args.gt)
        gt_poses = gt_poses[::args.stride]
        gt_ts = gt_ts[::args.stride]
        if len(gt_poses) == len(frames):
            poses = gt_poses
            ts = gt_ts
        else:  # nearest-neighbor timestamp association
            idx = np.abs(gt_ts[None, :] - ts[:, None]).argmin(axis=1)
            poses = gt_poses[idx]

    from sosvo.data.sequence import save_sequence

    save_sequence(args.out, images=frames, poses=poses, timestamps=ts)
    if args.sosq:
        from sosvo.data.native_loader import write_sosq

        write_sosq(args.sosq, frames)
    print(f"staged {len(frames)} frames {frames.shape[1]}x{frames.shape[2]} "
          f"-> {args.out}" + (f" + {args.sosq}" if args.sosq else "")
          + (" (with ground truth)" if poses is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
