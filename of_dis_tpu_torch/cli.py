"""Command-line driver of the PyTorch / CUDA port (optical flow and stereo),
mirroring of_dis_tpu/cli.py and the reference's run_OF_* / run_DE_* binaries
(run_dense.cpp:225-294, README.md:51-88):

  python -m of_dis_tpu_torch.cli img1 img2 out.flo                # operating point 2
  python -m of_dis_tpu_torch.cli img1 img2 out.flo --op 4
  python -m of_dis_tpu_torch.cli img1 img2 out.flo --params 5 3 12 12 0.05 0.95 0 8 0.4 0 1 0 1 10 10 5 1 3 1.6 2
  python -m of_dis_tpu_torch.cli left right out.pfm [--camlr 1]   # stereo
  python -m of_dis_tpu_torch.cli img1 img2 out.flo --device cpu   # plain PyTorch path

The mode follows the output's extension (.flo flow, .pfm stereo) unless
--mode names it; a .pfm holds the disparity negated, as the reference
writes it.  --rgb selects 3-channel input; --gradmag uses the
gradient-magnitude input image (reference SELECTCHANNEL==2).  Runs on CUDA
unless --device says otherwise.  -v 1 prints the total run time; -v 2 (the
default) runs utils/instrument.py::dis_flow_timed and prints the
reference's per-scale stage table (oflow.cpp:296-304), with the same output
as -v 0.  --viz IMG also writes an image of the result (Middlebury colour
wheel for flow, a grey ramp of |disparity| for stereo).
"""

from __future__ import annotations

import argparse
import sys

from . import io
from .config import DISConfig, operating_point
from .models.dis import dis_raw, resolve_device
from .ops.transfer import to_device, to_host
from .utils.timing import StageTimer


def _cfg_from_params(params, mode: str, channels: int, camlr: int = 0) -> DISConfig:
    """The 20 explicit positional parameters (run_dense.cpp:269-294)."""
    if len(params) != 20:
        raise SystemExit(f"--params needs exactly 20 values, got {len(params)}")
    p = params
    return DISConfig(
        mode=mode,
        channels=channels,
        camlr=camlr,
        sc_f=int(p[0]),
        sc_l=int(p[1]),
        max_iter=int(p[2]),
        min_iter=int(p[3]),
        dp_thresh=float(p[4]),
        dr_thresh=float(p[5]),
        res_thresh=float(p[6]),
        patch_size=int(p[7]),
        overlap=float(p[8]),
        use_fb_merge=bool(int(p[9])),
        patch_norm=bool(int(p[10])),
        cost=int(p[11]),
        use_tv_refine=bool(int(p[12])),
        tv_alpha=float(p[13]),
        tv_gamma=float(p[14]),
        tv_delta=float(p[15]),
        tv_innerit=int(p[16]),
        tv_solverit=int(p[17]),
        tv_sor=float(p[18]),
        verbosity=int(p[19]),
    ).validate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="of-dis-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("img1")
    ap.add_argument("img2")
    ap.add_argument("out")
    ap.add_argument("--op", type=int, default=2, choices=[1, 2, 3, 4])
    ap.add_argument("--params", type=float, nargs="*", default=None,
                    help="20 explicit parameters (reference variant 3)")
    ap.add_argument("--mode", choices=["flow", "stereo"], default=None,
                    help="default: stereo for a .pfm output, else flow")
    ap.add_argument("--rgb", action="store_true")
    ap.add_argument("--gradmag", action="store_true",
                    help="gradient-magnitude input image (SELECTCHANNEL==2)")
    ap.add_argument("--camlr", type=int, default=0, choices=[0, 1],
                    help="stereo camera: 0 left (disparity <= 0), 1 right")
    ap.add_argument("--init-flow", default=None,
                    help=".flo warm start at the coarsest scale (oflow.cpp:217-220)")
    ap.add_argument("--viz", default=None, metavar="IMG",
                    help="also write a visualization image (Middlebury color "
                         "wheel for flow, grayscale ramp for disparity), the "
                         "reference's DISVISUAL display (oflow.cpp:307-335)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    ap.add_argument("-v", "--verbosity", type=int, default=2)
    args = ap.parse_args(argv)

    mode = args.mode or ("stereo" if args.out.endswith(".pfm") else "flow")
    channels = 3 if args.rgb else 1
    device = resolve_device(args.device)

    timer = StageTimer(args.verbosity)
    with timer.stage("Image loading"):
        try:
            img1 = io.load_image(args.img1, channels)
            img2 = io.load_image(args.img2, channels)
        except FileNotFoundError as e:
            raise SystemExit(f"of-dis-torch: cannot open input image: {e.filename}")
    if img1.shape != img2.shape:
        raise SystemExit(
            f"of-dis-torch: input images differ in size: {img1.shape[:2]} vs {img2.shape[:2]}"
        )

    if args.params is not None:
        cfg = _cfg_from_params(args.params, mode, channels, args.camlr)
    else:
        cfg = operating_point(args.op, img1.shape[1], mode=mode, channels=channels,
                              verbosity=args.verbosity, camlr=args.camlr)

    init_flow = None
    if args.init_flow:
        from .ops.pyramid import pad_to_divisible, resize_bilinear

        # resize to scale sc_f+1 like the reference's (disabled) init path
        # (run_dense.cpp:355-378): scale values and resample.
        init = to_device(io.read_flo(args.init_flow), device)
        padded = pad_to_divisible(init, 1 << cfg.sc_f)
        fct = 2.0 ** (-cfg.sc_f - 1)
        init_flow = resize_bilinear(
            padded * fct, int(padded.shape[0] * fct), int(padded.shape[1] * fct)
        )

    if args.verbosity > 1:
        # Per-scale stage table (oflow.cpp:296-304): the same stage functions
        # as dis_raw, each waited for on the device.
        from .utils.instrument import dis_flow_timed

        out, _ = dis_flow_timed(img1, img2, cfg, verbosity=args.verbosity,
                                gradmag_input=args.gradmag, init_flow=init_flow,
                                device=device)
        out = to_host(out).numpy()
    else:
        with timer.stage("O.Flow Run-Time", sync=device):
            out = to_host(dis_raw(img1, img2, cfg, init_flow=init_flow,
                                  gradmag_input=args.gradmag, device=device)).numpy()

    with timer.stage("Saving flow file"):
        if mode == "flow":
            io.write_flo(args.out, out)
        else:
            io.write_pfm(args.out, out[..., 0])
    if args.viz:
        from .utils import viz

        if mode == "flow":
            viz.save_image(args.viz, viz.flow_to_color(out))
        else:
            viz.save_image(args.viz, viz.disparity_to_gray(out))
    if args.verbosity <= 1:
        # at verbosity 2 the instrumented run already printed the total
        timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
