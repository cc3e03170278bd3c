"""Headline benchmark of the port: codec throughput on one card, three configs.

    python -m dbde_tpu_torch.bench        # needs a CUDA GPU

Counterpart of the repository's ``bench.py`` (which benches the JAX
package), with its keys.  Prints ONE JSON line: the flagship config
(camera 2048x2048, 8 frames: decode Gpix/s as ``value``) at the top
level, as :func:`.bench_core.run_bench` reports it, and a ``configs``
object with a compact record of each config:

  * ``camera_2048`` -- the flagship again;
  * ``random_2048`` -- incompressible, every tile depth 8: the uniform
    pair (K4, K5);
  * ``random_2536x2048`` -- the reference test driver's bench geometry,
    a width that is not a multiple of 16.

Every config checks its decoded frames before it reports, and any failure
raises: nothing retries on another device or path.
"""

from __future__ import annotations

import json
import sys

from .bench_core import run_bench

# (key, run_bench arguments), as bench.py runs them
CONFIGS = (
    ("camera_2048", dict(width=2048, height=2048, frames=8, iters=20, content="camera")),
    ("random_2048", dict(width=2048, height=2048, frames=8, iters=12, content="random")),
    ("random_2536x2048", dict(width=2536, height=2048, frames=8, iters=12, content="random")),
)


def _sub(r: dict) -> dict:
    """Compact per-config record for the nested ``configs`` object."""
    return {
        "decode_gpix_per_s": r["value"],
        "decode_vs_baseline": r["vs_baseline"],
        "encode_gpix_per_s": r["encode_gpix_per_s"],
        "encode_vs_baseline": r["encode_vs_baseline"],
        "geometry": r["geometry"],
        "content": r["content"],
        "compression_ratio": r["compression_ratio"],
    }


def run(configs=CONFIGS, device="cuda") -> dict:
    """The bench line as a dict: the first config's full result with every
    config's compact record under ``configs``."""
    results = {key: run_bench(**kw, device=device) for key, kw in configs}
    out = dict(results[configs[0][0]])
    out["configs"] = {key: _sub(r) for key, r in results.items()}
    return out


def main() -> int:
    print(json.dumps(run(CONFIGS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
