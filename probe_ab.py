"""Parent/change A/B of the port's page timings on one card.

From the checkout at TREE (a directory holding chip_smoke.py and
ocr_inference_tpu_torch/, such as a ``git archive`` of the parent
unpacked into a gitignored directory), runs chip_smoke.py's build, then:

- ``phases``: chip_smoke.py's page_ocr_bf16, volume_bf16 and layout_bf16
  phases, each printing its JSON line;
- ``page``: 5 warm-up and 30 timed bf16 ``run_ocr`` calls of bench.py
  config 4's first page, the card synchronised around each, and 10 calls
  of ``chip_smoke.stage_ms``; prints ``AB {...}`` with the quartiles of
  the page ms and each stage's median ms.

Compare two trees only within one call, alternating them:

    for t in parent change change parent; do
        python3 probe_ab.py page $t; done
"""

import json
import os
import sys
import time


def main(mode: str, tree: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs

    cs.build()
    if cs.FAILED:
        return 1
    pipe = cs.full77f_pipeline(torch.bfloat16)
    if mode == "phases":
        results: dict = {}
        with cs.kernel_recorder(results):
            cs.page_ocr_bf16(pipe, results)
            cs.volume_bf16(pipe, results)
            del pipe
            cs.layout_bf16(results)
        return 1 if cs.FAILED else 0
    big = cs.bench_page(42)
    for _ in range(5):
        cs.run_page(pipe, big)
    times = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.run_page(pipe, big)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    stages = [cs.stage_ms(pipe, big) for _ in range(10)]
    print("AB", json.dumps({
        "tree": tree, "page_ms_q25_50_75":
            np.percentile(times, [25, 50, 75]).tolist(),
        "stage_median_ms": {k: float(np.median([s[k] for s in stages]))
                            for k in stages[0]},
        "gpu": cs.gpu_name_and_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("phases", "page"):
        sys.exit("usage: python3 probe_ab.py phases|page TREE")
    sys.exit(main(sys.argv[1], sys.argv[2]))
