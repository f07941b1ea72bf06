"""Segment artifact integrity: the CRC32 stamped at seal.

Counterpart of pinot_tpu/segment/integrity.py, the part the creator runs
(compute and stamp); verification and quarantine belong to the server
plane, which the port does not have yet.

Parity: the reference's segment CRC story — CrcUtils.computeCrc over the
segment files at build time, the crc stamped into SegmentZKMetadata, and
SegmentFetcherAndLoader verifying every downloaded artifact before it is
served (a mismatch fails the transition and the artifact is discarded).
Here the checksum covers every artifact file EXCEPT metadata.json — the
crc is stamped into metadata.json itself, so the metadata file cannot be
part of its own checksum (the reference excludes it the same way).

The checksum is layout-honest: it folds in each member's file name, so a
missing, renamed, or extra index file changes the crc even if the byte
streams happen to collide. v1 (file-per-index) and v3 (columns.psf) are
different artifacts and carry different crcs — the crc always describes
the bytes that actually travel and land on disk.
"""
from __future__ import annotations

import json
import os
import zlib

from pinot_tpu_torch.segment import format as fmt

_CHUNK = 1 << 20


def compute_crc(seg_dir: str) -> str:
    """CRC32 over every file in the segment directory except
    metadata.json, folding in file names (sorted) so structural changes
    are detected. Returned as a decimal string (SegmentMetadata.crc)."""
    crc = 0
    for name in sorted(os.listdir(seg_dir)):
        if name == fmt.METADATA_FILE or name.endswith(".tmp"):
            # .tmp files are staging leftovers (a crash between stage
            # and rename, e.g. at integrity.stamp_rename) — never part
            # of the durable payload, so they must not poison the crc
            # of an otherwise-intact artifact on cold-start rescan
            continue
        path = os.path.join(seg_dir, name)
        if os.path.isdir(path):
            continue           # segment artifacts are flat
        crc = zlib.crc32(name.encode("utf-8"), crc)
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
    return str(crc & 0xFFFFFFFF)


def stamp_crc(seg_dir: str) -> str:
    """Compute the artifact crc and stamp it into metadata.json via a
    staged write + atomic rename; returns the crc. Run at seal time
    (SegmentCreator.build) and lazily for pre-integrity artifacts
    entering the deep store. A crash mid-write leaves the old
    metadata.json intact."""
    crc = compute_crc(seg_dir)
    meta_path = os.path.join(seg_dir, fmt.METADATA_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["crc"] = crc
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, meta_path)
    return crc
