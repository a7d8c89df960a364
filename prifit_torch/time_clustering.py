"""Times the clustering kernels and FPS on the card at the main path's
shapes.

    python3 prifit_torch/time_clustering.py [--root DIR] [--probes]

Imports ``prifit_torch`` from ``DIR`` (default: this checkout), so that two
trees with the same kernel wrappers (an earlier commit unpacked beside
this one) can be timed in turns on one card: run it for each tree in one
call, alternating.  At B=24, N=2048, D=128 on ``chip_smoke.py``'s
embedding-like rows (seed 3) it times, by CUDA events: bandwidth at the
main path's rank, the 10 mean-shift forward launches of one forward, the
10 backward launches of one self-sup step (1 live cotangent row a shape)
and NMS on the modes after 10 mean-shift steps; and the two FPS calls of
one forward (B=24, 2048 -> 512 from a random start, then 512 -> 128 on
the centroids), together (``fps_ms``) and each alone, and the same with
the centroids' gather that an SA layer made where the tree's wrapper
returns indices only (``fps_centroids_ms``).  ``--probes`` adds
bandwidth on inputs that take its phases apart: rank 0 (no select: the
products, keys and histograms alone), 4 ranks (the select four times),
rows 32 wide (a quarter of the products) and rows that are all equal
(every key in one bin); and, where the tree's FPS takes a launch shape
(``kernels/fps.py::launch``), each FPS call at every block size with the
fewest points a thread.  Prints one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys


def cuda_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # run as a file, this package's directory heads sys.path; only root's
    # prifit_torch may be imported
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or os.curdir) != here]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_clustering: no CUDA device")
    from prifit_torch.clustering.mean_shift import mean_shift_iterations
    from prifit_torch.kernels import bandwidth, build, fps, mean_shift, nms

    build.build_all()
    B, N, D = 24, 2048, 128
    gen = torch.Generator().manual_seed(3)
    dirs = torch.randn((B, 12, D), generator=gen)
    pick = torch.randint(0, 12, (B, N), generator=gen)
    X = torch.gather(dirs, 1, pick[..., None].expand(-1, -1, D))
    X = X + 0.35 * torch.randn((B, N, D), generator=gen)
    X = (X / X.norm(dim=-1, keepdim=True)).cuda()
    ks = [int(0.05 * N)]
    kth = bandwidth.kth_nn_plain(X, ks)
    bw = torch.sqrt(torch.clamp_min(kth[:, 0], 1e-6)).mean(-1)
    bw2 = (bw ** 2).contiguous()
    m, s = mean_shift.mean_shift_step_fwd(X, X, bw2)
    g = torch.zeros((B, N, D))
    for b in range(B):
        g[b, torch.randperm(N, generator=gen)[:1]] = torch.randn(
            (1, D), generator=gen)
    g = g.cuda()
    with torch.no_grad():
        modes = mean_shift_iterations(X, bw, 10).contiguous()
    bwf = bw.float().contiguous()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = dict(
        root=root, card=smi,
        bandwidth_ms=cuda_ms(torch, lambda: bandwidth.kth_nn_distance(X, ks),
                             reps=20),
        mean_shift_10_ms=cuda_ms(torch, lambda: [
            mean_shift.mean_shift_step_fwd(X, X, bw2) for _ in range(10)],
            reps=3),
        mean_shift_bwd_10_ms=cuda_ms(torch, lambda: [
            mean_shift.mean_shift_step_bwd(X, X, bw2, m, s, g)
            for _ in range(10)], reps=3),
        nms_ms=cuda_ms(torch, lambda: nms.nms_passes(modes, bwf), reps=20))
    out.update(time_fps(torch, fps, args.probes))
    if args.probes:
        x32 = X[..., :32] / X[..., :32].norm(dim=-1, keepdim=True)
        same = X[:, :1].expand(-1, N, -1).contiguous()
        for name, x, kk in (("rank0", X, [0]), ("4ranks", X, ks * 4),
                            ("d32", x32.contiguous(), ks),
                            ("equal_rows", same, ks)):
            out[f"bandwidth_{name}_ms"] = cuda_ms(
                torch, lambda: bandwidth.kth_nn_distance(x, kk), reps=20)
    print(json.dumps(out), flush=True)


def time_fps(torch, fps, probes):
    """The two FPS calls of one forward, on inputs made the same way in
    every tree.  An earlier tree's wrapper returns the indices only (and
    casts the start and the indices around its kernel); its centroids were
    then an index gather, as its SA layer made them."""
    gen = torch.Generator().manual_seed(1)
    cgen = torch.Generator(device="cuda").manual_seed(1)
    B, N = 24, 2048
    xyz1 = torch.randn((B, N, 3), generator=gen).cuda()
    start1 = torch.randint(0, N, (B,), generator=cgen, device="cuda")
    start2 = torch.randint(0, 512, (B,), generator=cgen, device="cuda")
    ar = torch.arange(B, device="cuda")[:, None]

    def indices(out):
        return out[0] if isinstance(out, tuple) else out

    xyz2 = xyz1[ar, indices(fps.fps_plain(xyz1, 512, start1))].contiguous()
    calls = [(xyz1, 512, start1), (xyz2, 128, start2)]

    def centroids(x, k, st):
        out = fps.farthest_point_sample(x, k, st)
        return out if isinstance(out, tuple) else (out, x[ar, out])

    out = dict(
        fps_ms=cuda_ms(torch, lambda: [fps.farthest_point_sample(*c)
                                       for c in calls], reps=20),
        fps_centroids_ms=cuda_ms(torch, lambda: [centroids(*c)
                                                 for c in calls], reps=20),
        fps_sa1_ms=cuda_ms(torch, lambda: fps.farthest_point_sample(
            *calls[0]), reps=20),
        fps_sa2_ms=cuda_ms(torch, lambda: fps.farthest_point_sample(
            *calls[1]), reps=20))
    if probes and hasattr(fps, "launch"):
        for x, k, st in calls:
            n = x.shape[1]
            for t in fps.THREADS:
                p = -(-n // t)
                if p <= fps.MAX_PER_THREAD:
                    out[f"fps_{n}_T{t}_P{p}_ms"] = cuda_ms(
                        torch, lambda: fps.launch(x, k, st, t, p), reps=20)
    return out


if __name__ == "__main__":
    main()
