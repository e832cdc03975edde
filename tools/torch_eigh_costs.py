#!/usr/bin/env python3
"""
What non-Gaussian DALTON's eigendecompositions cost at q = 4 and 5 on the
card: ``torch.linalg.eigh`` of float32 4 x 4 and 5 x 5 batches of 1e5 to
2e6 matrices in chunks of 1024 to 100 352 matrices a call (a chunk that
cuSOLVER refuses is recorded with its error), and
``ops.fused_daltonng._masked_eigh`` (the unpacking, the eigendecomposition
in chunks of ``_EIGH_CHUNK`` and the relative screen) on the same
matrices packed, each with its time and peak memory.  The matrices are
seeded covariances of rank q - 1, as the smoothing passes' backward
kernels are (one structural null direction), in the layout ``(T, n_tri,
n_block, B)`` of the entries' operands with one block.

    python3 tools/torch_eigh_costs.py [--out FILE] [--sizes N,...]
        [--chunks N,...]

Prints one JSON line: the card's name and power limit, and for each q,
batch size and chunk the median milliseconds of 3 calls (1 below 4096
matrices a chunk) after a warm-up (CUDA events) and the peak memory above
what was allocated before the call.
Needs a CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def packed_covariances(q, n, device, seed=0):
    """``n`` seeded float32 q x q covariances of rank q - 1, packed upper
    triangles laid out ``(n // 2048, n_tri, 1, 2048)``."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    gen = torch.Generator(device).manual_seed(seed)
    a = torch.randn((n, q, q - 1), generator=gen, device=device)
    dense = a @ a.transpose(-1, -2)
    pairs, _ = fk._tri_idx(q)
    packed = torch.stack([dense[:, i, j] for i, j in pairs], -1)
    return packed.reshape(n // 2048, 2048, len(pairs)).permute(0, 2, 1)[
        :, :, None].contiguous(), dense


def timed(fn, repeats=3):
    """The median ms of ``repeats`` calls after a warm-up, and the peak
    memory of one call above what was allocated before it."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), torch.cuda.max_memory_allocated() - base


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--sizes", default="100352,1001472,2002944")
    parser.add_argument("--chunks", default="1024,8192,16384,32768,65536,"
                        "100352")
    args = parser.parse_args()
    chunks = [int(c) for c in args.chunks.split(",")]
    if not torch.cuda.is_available():
        sys.exit("torch_eigh_costs.py: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0),
           "smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "runs": []}
    for q in (4, 5):
        for n in map(int, args.sizes.split(",")):
            C, dense = packed_covariances(q, n, dev)
            row = {"q": q, "n": n, "chunks": {}}
            for chunk in chunks:
                if chunk > n:
                    continue
                try:
                    ms, peak = timed(lambda: [
                        torch.linalg.eigh(c) for c in dense.split(chunk)],
                        repeats=1 if chunk < 4096 else 3)
                    row["chunks"][chunk] = {
                        "ms": ms, "peak_bytes": peak,
                        "matrices_per_s": n / (ms * 1e-3)}
                except RuntimeError as err:
                    row["chunks"][chunk] = {"error": str(err)[:120]}
            row["masked_eigh_chunk"] = fdn._EIGH_CHUNK
            try:
                row["masked_eigh_ms"], row["masked_eigh_peak_bytes"] = \
                    timed(lambda: fdn._masked_eigh(C))
            except RuntimeError as err:
                row["masked_eigh_error"] = str(err)[:120]
            out["runs"].append(row)
            print(json.dumps(row), flush=True)
            del C, dense
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
