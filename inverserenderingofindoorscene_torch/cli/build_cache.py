"""Build the packed item cache of a dataset ahead of training.

The counterpart of the JAX package's ``cli/build_cache.py``.  The train
CLIs build the cache on first use (``--itemCache DIR``); this CLI builds
it beforehand, for each phase, and prints each shard directory's size.
A second run finds the complete caches and builds nothing; a killed
build resumes (``data/cache.py``).  A cache built here and one built by
the JAX package from the same tree share their directory and layout.

Usage: python -m inverserenderingofindoorscene_torch.cli.build_cache \
    --dataRoot $DATA --itemCache /cache/dir [--light] [--phases TRAIN TEST]
"""

from __future__ import annotations

import os
import os.path as osp
import time

from inverserenderingofindoorscene_torch.cli import common


def parse_args(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--light", action="store_true",
                   help="build the light-stage cache (with the envmap "
                        "shards) instead of the BRDF-stage one")
    p.add_argument("--phases", nargs="+", default=["TRAIN", "TEST"],
                   choices=["TRAIN", "TEST"])
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    if not opt.itemCache or not opt.dataRoot:
        raise ValueError("--itemCache DIR and --dataRoot are required")
    from inverserenderingofindoorscene_torch.data.cache import (
        CachedOpenRoomsDataset,
    )

    for phase in opt.phases:
        ds = common.make_dataset(opt, phase, is_light=opt.light)
        if len(ds) == 0:
            print(f"{phase}: 0 items, skipping")
            continue
        t0 = time.time()
        cached = CachedOpenRoomsDataset(
            ds, opt.itemCache, workers=max(opt.numWorkers, 1),
            half=opt.itemCacheHalf)
        size = sum(os.stat(osp.join(cached.dir, f)).st_size
                   for f in os.listdir(cached.dir))
        print(f"{phase}: {len(ds)} items -> {cached.dir} "
              f"({size / 1e6:.0f} MB, {time.time() - t0:.1f}s; "
              f"{'reused existing' if cached.reused else 'built'})")


if __name__ == "__main__":
    main()
