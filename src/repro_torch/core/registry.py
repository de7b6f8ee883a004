"""On-disk RSP store: the 'generated in advance and stored on the cluster'
half of the paper.  A partition is materialized once; afterwards block-level
samples are served by path lookup (no scan of the corpus).

Layout:
    <root>/manifest.json          RSPSpec + block descriptors + checksums
                                  (+ optional per-block summaries and meta)
    <root>/block_00042.npy        one RSP data block per file (mmap-readable)

The on-disk format is shared with the reference package byte for byte, so
a store written by either package opens in the other.

The parsed manifest (and the descriptors built from it) is cached per store
instance and invalidated when the manifest file's mtime changes, so repeated
``load_block(verify=True)`` calls don't re-read and re-parse JSON.

Prefer the ``repro_torch.rsp.RSPDataset`` facade (``ds.save(path)`` /
``rsp.open(path)``) for new code; it plumbs this store underneath.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Iterable

import numpy as np

from repro_torch.core.types import BlockDescriptor, RSPSpec
from repro_torch.device import as_numpy

_CHECKSUM_STEP_BYTES = 4 << 20


def _checksum(arr: np.ndarray) -> str:
    """Content hash of one block.  Hashing proceeds in bounded row slabs so
    memmapped blocks larger than RAM stream through without materializing."""
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    if arr.ndim == 0 or arr.shape[0] == 0:
        h.update(np.ascontiguousarray(arr).data)
        return h.hexdigest()[:16]
    row_bytes = max(1, arr.nbytes // arr.shape[0])
    step = max(1, _CHECKSUM_STEP_BYTES // row_bytes)
    for a in range(0, arr.shape[0], step):
        h.update(np.ascontiguousarray(arr[a : a + step]).data)
    return h.hexdigest()[:16]


class RSPStore:
    """Directory-backed store of one RSP data model."""

    MANIFEST = "manifest.json"
    SKETCHES = "sketches.json"

    def __init__(self, root: str):
        self.root = root
        self._cached_manifest: dict | None = None
        self._cached_descriptors: list[BlockDescriptor] | None = None
        self._cached_stat: tuple[int, int] | None = None
        # in-memory handoff from a streaming ingest: the SketchSuites folded
        # during the write, so the dataset facade need not re-parse the
        # (large) sketch sidecar it just streamed out.  Reopened stores
        # leave this None and parse the sidecar on demand.
        self.last_ingest_summaries: list | None = None

    # -- write --------------------------------------------------------------
    def write_partition(
        self,
        blocks: np.ndarray | Iterable[np.ndarray],
        spec: RSPSpec,
        *,
        summaries: list | None = None,
        meta: dict | None = None,
        sketch_schema: dict | None = None,
    ) -> None:
        """Materialize blocks + manifest.  ``summaries`` -- per-block sketch
        dicts or objects with ``to_dict()`` (see repro_torch.rsp.sketch /
        repro_torch.rsp.summaries) -- ``meta`` (free-form dataset metadata) and
        ``sketch_schema`` (the versioned descriptor of the sketch kinds each
        summary carries) ride along when provided.  With a ``sketch_schema``
        the (large) sketch payloads go to a ``sketches.json`` sidecar and
        the manifest stays light; without one they embed inline, which is
        the v1 layout old readers understand.

        Single-writer per store root: temp names are deterministic
        (``<block>.tmp.npy`` -> one ``os.replace``), so concurrent writers
        to the same root could publish each other's half-written temps.
        Readers are always safe -- blocks and manifest appear atomically."""
        os.makedirs(self.root, exist_ok=True)
        descriptors: list[BlockDescriptor] = []
        for k, block in enumerate(blocks):
            # tensors (on the card or the host) are written from a host copy:
            # the bytes on disk are the same whichever package wrote them
            block = as_numpy(block)
            path = self._block_path(k)
            # atomic write: deterministic temp name, one replace.  The .npy
            # suffix stops np.save from appending its own, so the temp file
            # written is exactly the file renamed.
            tmp = path + ".tmp.npy"
            np.save(tmp, block, allow_pickle=False)
            os.replace(tmp, path)
            descriptors.append(
                BlockDescriptor(
                    block_id=k,
                    num_records=int(block.shape[0]),
                    path=os.path.basename(path),
                    checksum=_checksum(block),
                )
            )
        self._sweep_stale(len(descriptors))
        self._publish_manifest(
            spec, descriptors, summaries=summaries, meta=meta,
            sketch_schema=sketch_schema,
        )

    def create_writer(self, spec: RSPSpec) -> "PartitionWriter":
        """Open a :class:`PartitionWriter` for streaming ingest: preallocated
        per-block ``.npy`` temps accepting offset-range row writes, published
        atomically by ``finalize()`` (streaming ingest)."""
        return PartitionWriter(self, spec)

    # -- read ---------------------------------------------------------------
    def spec(self) -> RSPSpec:
        return RSPSpec.from_json(json.dumps(self._manifest()["spec"]))

    def descriptors(self) -> list[BlockDescriptor]:
        self._manifest()  # refresh cache if the file changed
        if self._cached_descriptors is None:
            self._cached_descriptors = [
                BlockDescriptor(**d) for d in self._cached_manifest["blocks"]
            ]
        return self._cached_descriptors

    def summaries(self) -> list[dict] | None:
        """Per-block summary sketch dicts (None if absent).  v1 manifests
        carry them inline (cached with the manifest); v2 stores keep them in
        the ``sketches.json`` sidecar, parsed on every call and *not*
        cached -- the payload is large and callers (``RSPDataset``,
        ``BlockSource``) cache the converted suites instead."""
        m = self._manifest()
        if "summaries" in m:
            return m["summaries"]
        name = m.get("sketches_file")
        if name is None:
            return None
        with open(os.path.join(self.root, name)) as f:
            return json.load(f)["summaries"]

    def sketch_schema(self) -> dict | None:
        """Versioned sketch-schema descriptor (None for v1 manifests, which
        predate suites; their summaries upgrade lazily on load)."""
        return self._manifest().get("sketch_schema")

    def meta(self) -> dict:
        """Free-form dataset metadata from the manifest ({} if absent)."""
        return self._manifest().get("meta", {})

    def load_block(self, block_id: int, *, mmap: bool = True, verify: bool = False) -> np.ndarray:
        n = self.num_blocks()
        if not 0 <= block_id < n:
            raise IndexError(f"block {block_id} out of range [0, {n})")
        path = self._block_path(block_id)
        arr = np.load(path, mmap_mode="r" if mmap else None, allow_pickle=False)
        if verify:
            want = self.descriptors()[block_id].checksum
            got = _checksum(np.asarray(arr))
            if want != got:
                raise IOError(f"checksum mismatch for block {block_id}: {want} != {got}")
        return arr

    def load_blocks(self, block_ids: Iterable[int], **kw) -> np.ndarray:
        return np.stack([np.asarray(self.load_block(b, **kw)) for b in block_ids])

    def num_blocks(self) -> int:
        return len(self._manifest()["blocks"])

    # -- internals ----------------------------------------------------------
    def _sweep_stale(self, keep_blocks: int) -> None:
        """Drop stale blocks from any previous, larger partition in this root
        (so derived paths beyond the new K cannot serve old data) *and*
        orphaned ``.tmp.npy`` temps left by a crashed writer -- the
        single-writer contract means no live writer's temps coexist with a
        completed write."""
        for stray in os.listdir(self.root):
            if not stray.startswith("block_") or not stray.endswith(".npy"):
                continue
            path = os.path.join(self.root, stray)
            if stray.endswith(".tmp.npy"):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path)
                continue
            try:
                k = int(stray[len("block_"):-len(".npy")])
            except ValueError:
                continue
            if k >= keep_blocks:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path)

    def _publish_manifest(
        self,
        spec: RSPSpec,
        descriptors: list[BlockDescriptor],
        *,
        summaries: list | None = None,
        meta: dict | None = None,
        sketch_schema: dict | None = None,
    ) -> None:
        """Atomically publish the manifest -- the last step of any write, so
        readers never observe a manifest ahead of its blocks (the sketch
        sidecar, when any, lands just before it)."""
        manifest = {
            "spec": json.loads(spec.to_json()),
            "blocks": [dataclasses.asdict(d) for d in descriptors],
        }
        sketches_path = os.path.join(self.root, self.SKETCHES)
        if summaries is not None and sketch_schema is not None:
            # v2 layout: heavy sketch payloads stream to the sidecar one
            # suite at a time -- the writer never materializes the whole
            # serialized payload, and manifest reads stay cheap
            tmp = sketches_path + ".tmp"
            with open(tmp, "w") as f:
                f.write('{"version": %d, "summaries": [' % int(sketch_schema["version"]))
                for i, s in enumerate(summaries):
                    if i:
                        f.write(",")
                    json.dump(s.to_dict() if hasattr(s, "to_dict") else s, f)
                f.write("]}")
            os.replace(tmp, sketches_path)
            manifest["sketches_file"] = self.SKETCHES
            manifest["sketch_schema"] = sketch_schema
        elif summaries is not None:
            # v1 layout (no schema descriptor): inline summary dicts
            manifest["summaries"] = [
                s.to_dict() if hasattr(s, "to_dict") else s for s in summaries
            ]
        else:
            # this partition has no summaries: retire any stale sidecar so
            # a future layout change cannot pair it with this manifest
            with contextlib.suppress(FileNotFoundError):
                os.remove(sketches_path)
        if meta is not None:
            manifest["meta"] = meta
        tmp_manifest = os.path.join(self.root, self.MANIFEST + ".tmp")
        with open(tmp_manifest, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_manifest, os.path.join(self.root, self.MANIFEST))
        self._invalidate()

    def _invalidate(self) -> None:
        self._cached_manifest = None
        self._cached_descriptors = None
        self._cached_stat = None

    def _manifest(self) -> dict:
        """Parsed manifest, cached until the file changes.  The key is
        (mtime_ns, size) so rewrites within one coarse-mtime tick are still
        caught when the payload length differs."""
        path = os.path.join(self.root, self.MANIFEST)
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
        if self._cached_manifest is None or key != self._cached_stat:
            with open(path) as f:
                self._cached_manifest = json.load(f)
            self._cached_descriptors = None
            self._cached_stat = key
        return self._cached_manifest

    def _block_path(self, block_id: int) -> str:
        return os.path.join(self.root, f"block_{block_id:05d}.npy")


class PartitionWriter:
    """Offset-range block writer for streaming ingest (streaming ingest).

    Each block is preallocated as a ``<block>.tmp.npy`` temp via
    ``np.lib.format.open_memmap`` so row slices land directly at their
    destination offsets with no in-RAM assembly.  ``finalize()`` flushes,
    computes checksums *from the finished files*, retracts any previously
    published manifest, renames every temp into place, sweeps strays, and
    publishes the new manifest last.  A crash before the retraction leaves
    the old store fully intact (plus ``.tmp.npy`` orphans the next write
    sweeps); a crash after it leaves *no* manifest -- readers see a clean
    absence, never a stale manifest over replaced block files.

    Single-writer per store root, like ``write_partition``.
    """

    def __init__(self, store: RSPStore, spec: RSPSpec):
        os.makedirs(store.root, exist_ok=True)
        self.store = store
        self.spec = spec
        shape = (spec.block_size, *spec.record_shape)
        dtype = np.dtype(spec.dtype)
        self._tmp_paths = [
            store._block_path(k) + ".tmp.npy" for k in range(spec.num_blocks)
        ]
        self._mms: list[np.memmap] | None = [
            np.lib.format.open_memmap(p, mode="w+", dtype=dtype, shape=shape)
            for p in self._tmp_paths
        ]

    def write_rows(
        self, block_id: int, offsets: np.ndarray, values: np.ndarray
    ) -> None:
        """Write ``values`` into rows ``offsets`` of block ``block_id``.
        Disjoint offset ranges may be written concurrently from worker
        threads; each (block, row) is written exactly once per ingest."""
        self._mms[block_id][offsets] = values

    def finalize(
        self,
        *,
        summaries: list[dict] | None = None,
        meta: dict | None = None,
        sketch_schema: dict | None = None,
    ) -> RSPStore:
        """Publish the partition: checksum finished temps, rename into place,
        sweep strays, write the manifest.  Returns the store."""
        if self._mms is None:
            raise RuntimeError("writer already finalized or aborted")
        descriptors: list[BlockDescriptor] = []
        for k, mm in enumerate(self._mms):
            mm.flush()
            checksum = _checksum(mm)
            descriptors.append(
                BlockDescriptor(
                    block_id=k,
                    num_records=int(mm.shape[0]),
                    path=os.path.basename(self.store._block_path(k)),
                    checksum=checksum,
                )
            )
        self._mms = None  # drop the memmap references before renaming
        # retract any previously published manifest BEFORE touching its block
        # files: if we die mid-swap, readers find no store rather than an old
        # manifest silently describing a mixture of old and new blocks
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(self.store.root, self.store.MANIFEST))
        self.store._invalidate()
        for k, tmp in enumerate(self._tmp_paths):
            os.replace(tmp, self.store._block_path(k))
        self.store._sweep_stale(len(descriptors))
        self.store._publish_manifest(
            self.spec, descriptors, summaries=summaries, meta=meta,
            sketch_schema=sketch_schema,
        )
        return self.store

    def abort(self) -> None:
        """Remove the temps (failed ingest); the store root is left exactly
        as it was -- in particular any previously published manifest and its
        blocks stay intact."""
        self._mms = None
        for tmp in self._tmp_paths:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
