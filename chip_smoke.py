#!/usr/bin/env python
"""On-card smoke test: sosvo's main path, end to end, on the GPU.

    python chip_smoke.py                # one card: phases 0-6
    python chip_smoke.py --four-cards   # only the paths that span 4 cards

One process drives the card(s) and calls the normal entry points
(`sosvo.cli.main`, `sosvo.vo.pipeline.run_replay`) in-process: a second JAX
process would find the card's memory already reserved. Each phase prints one
line; any failed check raises and the script exits non-zero. The last line
of standard output is the JSON verdict
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
With no GPU the script exits non-zero and prints no verdict.

Phases on one card:
  0  device: platform, device_kind, nvidia-smi name and power limit
  1  kernels at real widths against plain references
  2  c1: observation-mode replay (bench.py's setup) through run_replay
  3  c2: rendered images -> frontend -> 5-keyframe BA, via sosvo.cli
  4  c3: K=2048 image-native replay with loop closure and PGO, via sosvo.cli
  5  c4: 4 batched sequences in BA mode on one card, via sosvo.cli
  6  memory: peak device bytes, and compile seconds per phase (set-up time)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

try:
    from sosvo.utils.runtime import (NoGPUError, gpu_name_and_power_limit,
                                     require_gpu, setup_compilation_cache)
except ImportError as e:  # run outside a checkout of the repo
    print(f"chip_smoke: the sosvo package is not importable ({e}); run this "
          "script from the root of a checkout", file=sys.stderr)
    sys.exit(2)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event in self.EVENTS:
            self.total += duration


@contextlib.contextmanager
def phase(n: int, name: str, clock: CompileClock, compile_s: dict):
    t0, c0 = time.perf_counter(), clock.total
    yield
    compile_s[name] = clock.total - c0
    print(f"phase {n} {name}: wall {time.perf_counter() - t0:.1f} s, "
          f"compile {compile_s[name]:.1f} s", flush=True)


def config(name: str) -> str:
    return str(ROOT / "configs" / f"{name}.json")


def run_cli(out: Path, *argv: str) -> dict:
    """`sosvo.cli.main` in this process; returns its report.json."""
    from sosvo import cli

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main([*argv, "--out", str(out)])
    check(rc == 0, f"sosvo.cli {' '.join(argv)} exited {rc}")
    (out / "stdout.log").write_text(log.getvalue())
    return json.loads((out / "report.json").read_text())


def median_call_s(f, *args, n: int = 100) -> float:
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_kernels() -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sosvo.backend.schur_reference import (SCHUR_RTOL_B, SCHUR_RTOL_S,
                                               schur_rel_errors)
    from sosvo.frontend import match as fm

    parts = []
    a = jax.random.bits(jax.random.PRNGKey(0), (2048, 8), dtype=jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (2048, 8), dtype=jnp.uint32)
    d_mxu = np.asarray(jax.jit(fm.hamming_matrix_mxu)(a, b))
    d_xor = np.asarray(jax.jit(fm.hamming_matrix_xor)(a, b))
    check(np.array_equal(d_mxu, d_xor),
          "bf16 +/-1 Hamming matrix differs from popcount-XOR at K=2048")
    parts.append("hamming K=2048 exact")
    for k in (512, 2048):
        va = jnp.ones(k, bool)
        f = jax.jit(lambda x, y, v: fm.match(x, y, v, v))
        t = median_call_s(f, a[:k], b[:k], va)
        parts.append(f"match K={k} {t * 1e6:.1f} us/call")

    for W, L in ((5, 1024), (8, 4096)):
        es, eb = schur_rel_errors(W, L, seed=W)
        check(es < SCHUR_RTOL_S and eb < SCHUR_RTOL_B,
              f"Schur (W={W}, L={L}) vs float64: rel err S {es:.2e}, b {eb:.2e}")
        parts.append(f"schur W={W} L={L} rel err S {es:.1e} b {eb:.1e}")
    return "; ".join(parts)


def phase_c1() -> str:
    import jax
    import jax.numpy as jnp

    from bench import c1_inputs
    from sosvo.eval.ate import ate_rmse
    from sosvo.vo.pipeline import run_replay

    rig, cfg, state, obs, scene = c1_inputs()
    _, outs = jax.block_until_ready(
        jax.jit(lambda s, o: run_replay(rig, cfg, s, o))(state, obs))
    ate = float(ate_rmse(outs.T_world[1:, :3, 3], scene.poses[1:, :3, 3])[0])
    check(bool(jnp.all(outs.pose_ok[1:])), f"c1 lost track: {outs.pose_ok}")
    check(ate < 0.02, f"c1 ATE {ate:.4f} m >= 0.02 m")
    return f"pose_ok all frames 1..; ATE {ate:.5f} m"


def one_card(out: Path, clock: CompileClock) -> None:
    import jax

    compile_s: dict = {}
    with phase(1, "kernels", clock, compile_s):
        print(f"  {phase_kernels()}")
    with phase(2, "c1", clock, compile_s):
        print(f"  {phase_c1()}")
    with phase(3, "c2", clock, compile_s):
        r = run_cli(out / "c2", "--config", config("c2_chip_ba"),
                    "--mode", "ba", "--ckpt-every", "60")
        check(r["ate_rmse_m"] < 0.02, f"c2 ATE {r['ate_rmse_m']} m >= 0.02 m")
        print(f"  ATE {r['ate_rmse_m']} m over {r['frames']} frames")
    with phase(4, "c3", clock, compile_s):
        r = run_cli(out / "c3", "--config", config("c3_host_pgo"),
                    "--ckpt-every", "200")
        check(r["pgo_loops"] > 0, "c3 closed no loop")
        check(r["ate_rmse_m"] < 0.03, f"c3 ATE {r['ate_rmse_m']} m >= 0.03 m")
        check(r["ate_rmse_m"] <= r["ate_rmse_vo_m"],
              f"c3 PGO raised ATE: {r['ate_rmse_vo_m']} -> {r['ate_rmse_m']}")
        print(f"  ATE VO {r['ate_rmse_vo_m']} m -> PGO {r['ate_rmse_m']} m, "
              f"{r['pgo_loops']} loop edges")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    with phase(5, "c4", clock, compile_s):
        r = run_cli(out / "c4", "--config", config("c4_batched_replay"),
                    "--mode", "ba", "--ckpt-every", "100")
        check(all(a < 0.05 for a in r["ate_per_sequence"]),
              f"c4 per-sequence ATE {r['ate_per_sequence']}")
        print(f"  ATE per sequence {r['ate_per_sequence']} m, mesh {r['mesh']}")
    print(f"phase 6 memory: peak_bytes_in_use after phase 4 {peak}; "
          f"compile s per phase (set-up) "
          f"{ {k: round(v, 1) for k, v in compile_s.items()} }", flush=True)


# Limit on the pose difference between c4 sharded over 4 cards (batch 1 per
# card) and the 4 sequences batched on one card. On one H100, batch 4 and
# 4 x batch 1 of the same inputs differ by 1.4e-6 to 2.9e-3 over 40 to 100
# frames (scripts/batch_drift.py, 3 seeds x 3 sizes; 6.5e-4 on c4's own
# inputs; this check read 6.5e-4 in one four-card run and 4.2e-6 in
# another), while each program repeats itself bit for bit: the two batch
# sizes compile to kernels that round differently, and RANSAC's inlier
# decisions amplify the last bits. The limit sits above those readings, so it fails
# only a coupling across the sequence axis that moves a pose by more than
# 5 mm; the tight checks of the batched path against each sequence alone
# are the CPU tests (tests/test_batched_replay.py).
C4_BATCH_DRIFT_LIMIT = 5e-3


def four_cards(out: Path, clock: CompileClock) -> None:
    import __graft_entry__

    compile_s: dict = {}
    with phase(1, "c5-sharded-ba", clock, compile_s):
        r = run_cli(out / "c5", "--config", config("c5_multihost"),
                    "--mode", "ba", "--verify-sharded", "--ckpt-every", "100")
        check(r["mesh"] == {"model": 4}, f"c5 mesh {r['mesh']}")
        d = r["sharded_vs_single_max_pose_diff"]
        check(d < 1e-4, f"c5 sharded vs single-card pose diff {d}")
        print(f"  mesh {r['mesh']}; sharded vs single max pose diff {d:.2e}; "
              f"ATE {r['ate_rmse_m']} m")
    with phase(2, "c4-data-sharded", clock, compile_s):
        r = run_cli(out / "c4", "--config", config("c4_batched_replay"),
                    "--mode", "ba", "--verify-sharded", "--ckpt-every", "100")
        check(r["mesh"] == {"data": 4}, f"c4 mesh {r['mesh']}")
        d_share = r["sharded_vs_per_device_share_max_pose_diff"]
        check(d_share < 1e-5,
              f"c4 sharded vs each card's share on one card: pose diff {d_share}")
        d = r["sharded_vs_single_max_pose_diff"]
        check(d < C4_BATCH_DRIFT_LIMIT,
              f"c4 sharded vs all 4 sequences batched on one card: pose diff {d}")
        print(f"  mesh {r['mesh']}; max pose diff vs one card: batched {d!r}, "
              f"per-card share {d_share!r}; "
              f"ATE per sequence {r['ate_per_sequence']} m")
    with phase(3, "dryrun_multichip", clock, compile_s):
        __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths that span four cards")
    ap.add_argument("--out", default=str(ROOT / "runs" / "chip_smoke"),
                    help="directory for the CLI runs' reports and logs")
    args = ap.parse_args(argv)

    gpu = gpu_name_and_power_limit()  # before JAX opens the card
    import jax

    cache = setup_compilation_cache()
    devices = jax.devices()
    try:
        require_gpu(devices)
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.four_cards and len(devices) != 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    dev = devices[0]
    print(f"phase 0 device: {dev.platform} {dev.device_kind} x{len(devices)}; "
          f"jax {jax.__version__}; compile cache {cache}", flush=True)
    print(f"nvidia-smi: {gpu}", flush=True)

    clock = CompileClock()
    out = Path(args.out)
    if args.four_cards:
        four_cards(out, clock)
    else:
        one_card(out, clock)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
