"""Segment v1 on-disk format constants.

Parity: pinot-core/.../segment/creator/impl/V1Constants.java — file-per-index
layout. We keep the same logical content (dictionary, forward index, inverted
index, bloom, metadata) with numpy-native containers:

    <segment_dir>/
      metadata.json              segment + per-column metadata
      creation.meta.json         build info
      <col>.dict.npy             numeric dictionary (sorted values)
      <col>.dict.bytes / .offsets.npy   string/bytes dictionary
      <col>.sv.fwd.npy           bit-packed dictId forward index (uint32 words)
      <col>.sv.sorted.fwd.npy    sorted column: [cardinality, 2] doc-id ranges
      <col>.mv.fwd.npy / <col>.mv.offsets.npy   multi-value forward index
      <col>.sv.raw.fwd.npy       raw (no-dictionary) values
      <col>.inv.docids.npy / <col>.inv.offsets.npy  CSR inverted index
      <col>.bloom.npy            bloom filter bit array
"""

METADATA_FILE = "metadata.json"
CREATION_META_FILE = "creation.meta.json"

DICT_NUMERIC = "{col}.dict.npy"
DICT_BYTES = "{col}.dict.bytes"
DICT_OFFSETS = "{col}.dict.offsets.npy"

SV_FWD = "{col}.sv.fwd.npy"
SV_SORTED_FWD = "{col}.sv.sorted.fwd.npy"
SV_RAW_FWD = "{col}.sv.raw.fwd.npy"
MV_FWD = "{col}.mv.fwd.npy"
MV_OFFSETS = "{col}.mv.offsets.npy"
# VECTOR column: packed fixed-width [num_docs, dimension] float32 block
VEC_FWD = "{col}.vec.fwd.npy"
# IVF ANN index members (built at seal when the table's vector index
# config enables it): trained k-means centroids [numCentroids, dim] f32,
# per-row coarse assignments [num_docs] int32, and training metadata
# (seed / iterations / mean assignment distance baseline for drift).
IVF_CENTROIDS = "{col}.ivf.centroids.npy"
IVF_ASSIGN = "{col}.ivf.assign.npy"
IVF_META = "{col}.ivf.meta.json"

INV_DOCIDS = "{col}.inv.docids.npy"
INV_OFFSETS = "{col}.inv.offsets.npy"

BLOOM = "{col}.bloom.npy"

SEGMENT_VERSION = "v1"

# -- v3 single-file container -----------------------------------------------
# Parity: SegmentVersion.java:21-24 + SingleFileIndexDirectory — every index
# lives inside ONE columns.psf container. Here the container is a (optionally
# DEFLATE-compressed) zip of the v1 members, which also supplies the chunk
# compression role of ChunkCompressorFactory (PASS_THROUGH | compressed).
COLUMNS_PSF = "columns.psf"
SEGMENT_VERSION_V3 = "v3"


class SegmentDir:
    """Virtual segment directory over either layout.

    v1: file-per-index in a real directory. v3: a single columns.psf zip
    whose members are the v1 files (arrays as .npy, raw members as
    bytes). Readers go through load_array/read_bytes/read_text/exists and
    never know which layout is underneath (parity: SegmentDirectory).
    """

    def __init__(self, path: str):
        import os
        self.path = path
        psf = os.path.join(path, COLUMNS_PSF)
        self._zip = None
        if os.path.exists(psf):
            import zipfile
            self._zip = zipfile.ZipFile(psf, "r")
            self._names = set(self._zip.namelist())

    def exists(self, name: str) -> bool:
        import os
        if self._zip is not None and name in self._names:
            return True
        return os.path.exists(os.path.join(self.path, name))

    def load_array(self, name: str):
        import io
        import os

        import numpy as np
        if self._zip is not None and name in self._names:
            with self._zip.open(name) as f:
                return np.load(io.BytesIO(f.read()))
        return np.load(os.path.join(self.path, name))

    def read_bytes(self, name: str) -> bytes:
        import os
        if self._zip is not None and name in self._names:
            return self._zip.read(name)
        with open(os.path.join(self.path, name), "rb") as f:
            return f.read()

    def read_text(self, name: str) -> str:
        return self.read_bytes(name).decode("utf-8")

    def list(self, suffix: str = "", prefix: str = "") -> list:
        """Member names across BOTH layouts (zip members union loose
        files), filtered by prefix/suffix — layout knowledge stays here."""
        import os
        names = set(self._names) if self._zip is not None else set()
        if os.path.isdir(self.path):
            names.update(n for n in os.listdir(self.path)
                         if not os.path.isdir(os.path.join(self.path, n)))
        return sorted(n for n in names
                      if n.startswith(prefix) and n.endswith(suffix))


def open_dir(seg_dir) -> "SegmentDir":
    """str → SegmentDir (idempotent for SegmentDir inputs)."""
    return seg_dir if isinstance(seg_dir, SegmentDir) else SegmentDir(seg_dir)
