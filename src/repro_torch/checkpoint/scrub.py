"""StoreScrubber: the store-wide integrity scrub and repair (fsck) of the
port, the JAX package's ``repro/checkpoint/scrub.py`` with its report.

A flipped bit in an object no restore reads until the one that needs it
turns a recoverable incident into a lost checkpoint.  The scrub walks every
committed manifest and checks every object they name, entries and delta
bases, in EVERY tier that holds a copy (``ChunkStore.verify_object_blob``:
envelope, codec, delta base replayed through the store, the digest, and an
fp object's table recomputed on ``device``: the ``block_fp`` kernel on the
card, its plain version on the CPU), and heals what it can:

- a tier holding a corrupt copy is rewritten bit-exact from a tier holding
  a good one (equal digests carry equal bytes);
- the DEEPEST tier missing its copy is backfilled from a good one (a
  degraded commit whose process died left replication debt no spill state
  remembers);
- an object corrupt in every tier is rebuilt where the store's canonical
  cache still holds its payload (a scrub after a save in one process): a
  fresh full envelope under the same digest, valid because a canonical
  digest hashes the payload, not the envelope;
- anything else is unrecoverable: its digest is quarantined with its
  manifests and units (``QUARANTINE.json``), so the restore's planner
  skips those candidates up front.

Objects are checked bases before dependents, so a base is repaired before
a delta on it is judged.  The copies are checked on a few threads (file
reads, crc32s and hashes leave the GIL; a copy is read into pinned memory
for a card), the largest first, a dependent's once its base is
settled; digests are settled, repaired and reported in the walk's order,
so the report is the JAX scrub's whatever the thread count.  A tier that cannot be read (a remote outage) is
skipped, not "repaired".  A later scrub that finds a quarantined digest
good again releases it.  ``repair=False`` is an audit: the report alone,
no write and no quarantine change.  ``CodecUnavailable`` (a zstd frame
that needs a dictionary) propagates: it is no evidence of corruption.
Shard objects (a shard set's refs) are checked like any other object.
"""
from __future__ import annotations

import logging
import mmap
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.chunk_store import ChunkStore, content_digest
from repro_torch.checkpoint.restore import (DEFAULT_IO_THREADS,
                                            host_buffer_alloc)
from repro_torch.checkpoint.serial import ChunkCorruption
from repro_torch.core.manifest import ManifestStore
from repro_torch.devices import resolve_device

log = logging.getLogger("repro_torch.checkpoint.scrub")

REPORT_VERSION = 1


class StoreScrubber:
    """Walks the committed manifests of ``store`` and checks and repairs
    every object they name across all its tiers, verifying tables on
    ``device`` (``devices.resolve_device``: the card unless the caller asks
    for the CPU)."""

    def __init__(self, store: ChunkStore,
                 manifests: Optional[ManifestStore] = None, *,
                 device=None) -> None:
        self.store = store
        self.manifests = manifests or ManifestStore(store.root)
        self.device = resolve_device(device)
        # the restore's reader count: more threads did not check faster
        # on the H100 host it was measured on (PERF.md, section 6)
        self.threads = DEFAULT_IO_THREADS
        self._alloc = host_buffer_alloc(self.device)

    # ------------------------------------------------------------ walk
    def _collect(self) -> Tuple[Dict[str, Dict[str, Any]], List[int]]:
        """digest -> {"manifests": [steps], "units": [(unit, kind)]} over
        every committed manifest, and the steps walked."""
        prov: Dict[str, Dict[str, Any]] = {}
        steps = self.manifests.all_steps()
        for step in steps:
            m = self.manifests.load(step)
            if m is None:  # deleted by a retention GC meanwhile
                continue
            for digest, sites in m.digest_provenance().items():
                rec = prov.setdefault(digest, {"manifests": [], "units": []})
                rec["manifests"].append(step)
                for unit, kind, _role in sites:
                    if (unit, kind) not in rec["units"]:
                        rec["units"].append((unit, kind))
        return prov, steps

    @staticmethod
    def _peek_base(tier, digest: str) -> Optional[str]:
        """The ``base`` of a tier's copy of ``digest``, which must parse as
        a whole; a file is mapped, so its payload is never read."""
        path = tier.path_of(digest)
        if path is None:
            env = _msgpack.unpackb(tier.read(digest), zero_copy=True)
            return env.get("base") if isinstance(env, dict) else None
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        parsed = False
        try:
            env = _msgpack.unpackb(mm, zero_copy=True)
            base = env.get("base") if isinstance(env, dict) else None
            parsed = True
        except ValueError:
            pass    # leaving the handler drops the views into the map
        env = None
        mm.close()
        if not parsed:
            raise ValueError(f"copy of {digest} does not parse")
        return base

    def _base_of(self, digest: str) -> Optional[str]:
        """The delta base of ``digest`` per the first tier whose copy
        parses (None when none does: the order then treats it as a
        leaf)."""
        for tier in self.store.backend.tier_backends().values():
            try:
                if not tier.has(digest):
                    continue
                return self._peek_base(tier, digest)
            except Exception:  # noqa: BLE001 - corrupt copies expected here
                continue
        return None

    def _ordered(self, digests: Set[str]
                 ) -> Tuple[List[str], Dict[str, Optional[str]]]:
        """Bases before dependents (delta chains verify bottom-up): the
        walk's order, and each digest's parent in it (its base, where that
        comes first: not past a cycle's break)."""
        base_of = {d: self._base_of(d) for d in digests}
        order: List[str] = []
        seen: Set[str] = set()

        def visit(d: str, trail: Set[str]) -> None:
            if d in seen or d not in digests:
                return
            b = base_of.get(d)
            if b and b not in trail:  # the trail stops a corrupt base cycle
                visit(b, trail | {d})
            if d not in seen:
                seen.add(d)
                order.append(d)

        for d in sorted(digests):  # sorted: deterministic reports
            visit(d, set())
        rank = {d: i for i, d in enumerate(order)}
        parent = {d: (base_of[d] if base_of[d] in rank
                      and rank[base_of[d]] < rank[d] else None)
                  for d in order}
        return order, parent

    def _size(self, digest: str) -> int:
        try:
            return self.store.object_size(digest)
        except Exception:  # noqa: BLE001 - only an order hint
            return 0

    # ---------------------------------------------------------- verify
    def _check_tier(self, label: str, tier, digest: str) -> Optional[bool]:
        """True: a good copy; False: a corrupt one; None: no copy."""
        try:
            if not tier.has(digest):
                return None
            blob = tier.read_into(digest, self._alloc)
        except FileNotFoundError:
            return None
        except OSError:
            # an unreachable tier (remote outage) is no evidence of
            # corruption: skip it this scrub, repair nothing there
            log.warning("scrub: tier %s unreachable for %s; skipping",
                        label, digest)
            return None
        try:
            self.store.verify_object_blob(digest, blob, self.device)
            return True
        except ChunkCorruption:
            return False

    def _rederive(self, digest: str) -> Optional[bytes]:
        """A full envelope for ``digest`` rebuilt from the store's
        canonical cache, when no tier holds a good copy; canonical digests
        only (an fp digest hashes a table that went with the envelope)."""
        canon = self.store._canon_cached(digest)
        if canon is None or content_digest(canon) != digest:
            return None
        if isinstance(canon, _msgpack.Blob):
            canon = b"".join(canon.parts)
        env = {"v": 1, "format": "full", "codec": "none",
               "payload": bytes(canon)}
        return _msgpack.packb(env)

    def _settle(self, digest: str, verdicts: Dict[str, bool], tiers,
                prov, repair: bool) -> Tuple[str, List[Dict[str, Any]]]:
        """Judge one digest on its tiers' verdicts and, with ``repair``,
        heal it: ``("healthy", [])``, ``("repaired", records)`` or
        ``("unrecoverable", [record])``."""
        good = [lbl for lbl, ok in verdicts.items() if ok]
        bad = [lbl for lbl, ok in verdicts.items() if not ok]
        # absence from a faster tier is eviction; from the deepest, debt
        deepest = next(reversed(tiers)) if len(tiers) > 1 else None
        missing_deep = (deepest is not None and good
                        and deepest not in verdicts)
        if good and not bad and not missing_deep:
            return "healthy", []
        if good:  # replicate the good copy over corrupt/missing ones
            src = good[0]
            fix = bad + ([deepest] if missing_deep else [])
            if repair:
                blob = tiers[src].read(digest)
                for lbl in fix:
                    try:
                        tiers[lbl].write(digest, blob)
                    except OSError as e:
                        # unreachable mid-repair: the good copies stand;
                        # the next scrub retries
                        log.warning("scrub: repair write of %s to tier %s "
                                    "failed (%s)", digest, lbl, e)
            recs = []
            if bad:
                recs.append({"digest": digest, "bad_tiers": bad,
                             "repaired_from": src, "method": "replicate",
                             "repaired": bool(repair)})
            if missing_deep:
                recs.append({"digest": digest, "bad_tiers": [deepest],
                             "repaired_from": src, "method": "backfill",
                             "repaired": bool(repair)})
            return "repaired", recs
        blob = self._rederive(digest) if repair else None
        if blob is not None:
            for lbl in (bad or list(tiers)):
                tiers[lbl].write(digest, blob)
            return "repaired", [{"digest": digest, "bad_tiers": bad,
                                 "repaired_from": "canonical-cache",
                                 "method": "rederive", "repaired": True}]
        reason = ("corrupt in every tier" if bad
                  else "missing from every tier")
        return "unrecoverable", [{
            "digest": digest, "reason": reason, "bad_tiers": bad,
            "manifests": prov[digest]["manifests"],
            "units": [list(uk) for uk in prov[digest]["units"]]}]

    # ------------------------------------------------------------ scrub
    def scrub(self, *, repair: bool = True) -> Dict[str, Any]:
        """Check every manifest-named object in every tier; repair what a
        good copy (or the canonical cache) allows; quarantine the rest.
        Returns the fsck report (the JAX package's schema)."""
        t0 = time.monotonic()
        self.store.drain_spill()  # settle spills in flight first
        prov, steps = self._collect()
        tiers = self.store.backend.tier_backends()
        checked_tiers = {label: 0 for label in tiers}
        # digest -> ("healthy" | "repaired" | "unrecoverable", records)
        outcome: Dict[str, Tuple[str, List[Dict[str, Any]]]] = {}
        order, parent = self._ordered(set(prov))
        children: Dict[str, List[str]] = {}
        for d in order:
            if parent[d] is not None:
                children.setdefault(parent[d], []).append(d)
        with ThreadPoolExecutor(self.threads) as pool:
            checks: Dict[Tuple[str, str], Any] = {}

            def submit(digests: List[str]) -> None:
                # the largest first: the pool's queue is FIFO
                for d in sorted(digests, key=self._size, reverse=True):
                    for label, tier in tiers.items():
                        checks[(d, label)] = pool.submit(
                            self._check_tier, label, tier, d)

            submit([d for d in order if parent[d] is None])
            for digest in order:     # settled in the walk's order
                verdicts = {}
                for label in tiers:
                    v = checks.pop((digest, label)).result()
                    if v is not None:
                        checked_tiers[label] += 1
                        verdicts[label] = v
                outcome[digest] = self._settle(digest, verdicts, tiers,
                                               prov, repair)
                # a dependent is checked once its base is settled
                submit(children.get(digest, []))
        healthy: List[str] = []
        repaired: List[Dict[str, Any]] = []
        unrecoverable: List[Dict[str, Any]] = []
        for digest in order:
            kind, recs = outcome[digest]
            if kind == "healthy":
                healthy.append(digest)
            else:
                (repaired if kind == "repaired" else
                 unrecoverable).extend(recs)
        bad_digests = {rec["digest"] for rec in unrecoverable}

        demoted = sorted({s for rec in unrecoverable
                          for s in rec["manifests"]})
        released: List[str] = []
        if repair:
            # add this scrub's unrecoverables; release the digests that
            # are good again (an operator restored the bytes)
            q = self.store.quarantine()
            released = [d for d in q if d not in bad_digests and d in prov]
            for d in released:
                q.pop(d, None)
            for rec in unrecoverable:
                q[rec["digest"]] = {"reason": rec["reason"],
                                    "manifests": rec["manifests"],
                                    "units": rec["units"]}
            self.store.set_quarantine(q)

        report = {
            "v": REPORT_VERSION,
            "manifest_steps": steps,
            "checked_objects": len(prov),
            "checked_tiers": checked_tiers,
            "healthy": len(healthy),
            "repaired": repaired,
            "unrecoverable": unrecoverable,
            "demoted_manifests": demoted,
            "released_from_quarantine": released,
            "quarantined": len(self.store.quarantine()),
            "repair": bool(repair),
            "elapsed_s": round(time.monotonic() - t0, 6),
        }
        if repaired or unrecoverable:
            log.warning("scrub: %d object(s) checked, %d repaired, %d "
                        "unrecoverable (manifests demoted: %s)", len(prov),
                        len(repaired), len(unrecoverable), demoted or "none")
        else:
            log.info("scrub: %d object(s) checked, all healthy", len(prov))
        return report


def scrub_root(root, *, backend: "str | Any" = "local",
               repair: bool = True,
               remote_opts: Optional[Dict[str, Any]] = None,
               device=None) -> Dict[str, Any]:
    """Open the store at ``root`` (``backend`` and ``remote_opts`` as for
    ``ChunkStore``), scrub it on ``device`` and close it."""
    dev = resolve_device(device)
    store = ChunkStore(root, backend=backend, remote_opts=remote_opts)
    try:
        return StoreScrubber(store, device=dev).scrub(repair=repair)
    finally:
        store.close()
