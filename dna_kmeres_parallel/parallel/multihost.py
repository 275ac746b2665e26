"""Multi-host ingestion and mesh glue.

The reference is strictly single-process (SURVEY.md §2.5). Multi-host runs
here follow the standard JAX recipe:

1. every process calls ``init_distributed()`` (jax.distributed.initialize,
   env-driven) so ``jax.devices()`` spans the pod slice;
2. the input FASTA is split into **record-aligned byte ranges**, one per
   host — each host reads a disjoint range that starts exactly at a record
   header, so no record is dropped or double-counted (SURVEY.md §7 hard
   part: "record-boundary-aligned multi-host file sharding");
3. each host parses/encodes its range locally and contributes its shard of
   the global stream via ``jax.make_array_from_process_local_data``;
4. the jitted sharded count (parallel/sharded_count.py) runs on the global
   mesh — histogram merge is an integer psum over ICI/DCN, bit-exact.
"""

from __future__ import annotations

import os

import numpy as np


def split_fasta_byte_ranges(path: str, n_parts: int) -> list[tuple[int, int]]:
    """Split a FASTA file into n record-aligned byte ranges.

    Each range starts at the beginning of a record header line ('>' at file
    start or right after a newline). Ranges partition the file: every byte
    belongs to exactly one range, and every record lies entirely within one
    range (records are never split because boundaries are record starts).
    """
    size = os.path.getsize(path)
    if n_parts <= 1 or size == 0:
        return [(0, size)]
    bounds = [0]
    with open(path, "rb") as f:
        for i in range(1, n_parts):
            target = size * i // n_parts
            search_start = max(target - 1, 0)
            f.seek(search_start)
            # Scan forward for the next "\n>" (a record start), keeping a
            # 1-byte overlap so the pattern is seen across read boundaries.
            pos = None
            abs_pos = search_start
            overlap = b""
            while pos is None:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                buf = overlap + chunk
                j = buf.find(b"\n>")
                if j >= 0:
                    pos = abs_pos - len(overlap) + j + 1
                    break
                abs_pos += len(chunk)
                overlap = buf[-1:]
            bounds.append(pos if pos is not None else size)
        bounds.append(size)
    # De-duplicate (ranges may collapse if records are huge) but keep order.
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        out.append((a, max(a, b)))
    return out


def read_range_records(path: str, start: int, end: int):
    """Parse the records whose header starts within [start, end)."""
    from dna_kmeres_parallel.utils import fasta

    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    return fasta.parse_fasta(data)


def encode_range_stream(path: str, start: int, end: int) -> tuple[np.ndarray, int, int]:
    """Byte range -> flat encoded stream (0xFF sentinels): one host's share
    of the input. Native single-pass range parser when available (the
    per-host ingest is GB-scale); Python fallback otherwise."""
    from dna_kmeres_parallel import native

    if native.available():
        parsed = native.parse_fasta_native(path, byte_range=(start, end))
        return parsed.stream, parsed.total_bases, parsed.n_seqs

    from dna_kmeres_parallel.utils import codec

    records = read_range_records(path, start, end)
    flat = codec.concat_with_sentinels([r.seq for r in records])
    return flat, sum(len(r.seq) for r in records), len(records)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize with env fallbacks (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). No-op when single-process."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_global_stream(local_flat: np.ndarray, mesh, axis: str = "data"):
    """Assemble the global sharded stream from per-process local shards.

    Pads the local shard to the per-process slice size agreed across hosts
    (callers must pass the same global length on every process via the mesh
    contract). Single-process: equivalent to device_put_sharded_stream.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dna_kmeres_parallel.ops.encode import INVALID

    # Pad to the PER-PROCESS share of the mesh axis (not the local device
    # count: a sub-mesh spanning fewer devices than the process owns would
    # otherwise produce a global length not divisible by the axis size).
    n_local = max(mesh.shape[axis] // max(jax.process_count(), 1), 1)
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        pad = (-local_flat.shape[0]) % n_local
        if pad:
            local_flat = np.concatenate(
                [local_flat, np.full(pad, INVALID, dtype=np.uint8)]
            )
        return jax.device_put(local_flat, sharding)
    # Hosts' ranges differ in length; agree on the max and pad every local
    # shard to it (INVALID padding never counts) so the global shape is
    # consistent across processes. target is max + 1, NOT max: each
    # process's records are complete, so no window may span two processes'
    # slabs — without the guaranteed trailing INVALID, the LONGEST slab
    # (which gets no padding) would sit flush against the next process's
    # first record and the halo exchange would count k-1 phantom
    # cross-process windows (caught by the 2-process gloo test).
    from jax.experimental import multihost_utils

    lengths = multihost_utils.process_allgather(
        np.array([local_flat.shape[0]], dtype=np.int64)
    )
    target = int(np.max(lengths)) + 1
    target += (-target) % n_local
    pad = target - local_flat.shape[0]
    if pad:
        local_flat = np.concatenate(
            [local_flat, np.full(pad, INVALID, dtype=np.uint8)]
        )
    global_len = target * jax.process_count()
    return jax.make_array_from_process_local_data(
        sharding, local_flat, (global_len,)
    )


def _ckpt_file(base: str, rank: int, gen: int) -> str:
    return f"{base}.p{rank}.g{gen}.npz"


def count_file_multihost_resumable(
    path: str,
    config,
    mesh,
    axis: str = "data",
    checkpoint_path: str | None = None,
    batch_bases: int | None = None,
    max_steps: int | None = None,
):
    """Batched, checkpointed multi-host dense count (SURVEY.md §5's
    "jax.distributed restart with resume-from-last-merged-histogram").

    Every process executes the SAME globally-agreed number of steps
    (ceil(max range length / batch)): step s slices the local range
    [s*batch, s*batch + batch + k - 1) — the k-1 tail is the halo, so a
    step owns exactly the windows STARTING inside its batch — pads it into
    a fixed INVALID-guarded slab, and psum-merges the step histogram over
    the mesh. After each step every process atomically saves (steps_done,
    merged hist) to its own TWO-GENERATION checkpoint file; a restart
    resumes from the newest step EVERY process has on disk (a kill can
    interleave saves across processes by at most one step, and the older
    generation covers the rollback). Integer adds make the resumed result
    bit-identical to a single-shot run at any device count.

    max_steps: stop after N steps this call (checkpointing progress) —
    kill/preemption simulation for tests. Returns (hist, total_bases,
    n_seqs, steps_done, n_steps).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dna_kmeres_parallel.ops.encode import INVALID
    from dna_kmeres_parallel.parallel import sharded_count as sc
    from dna_kmeres_parallel.utils import checkpoint as ckpt_mod

    if not config.dense:
        raise ValueError(
            "count_file_multihost_resumable is the dense-histogram path "
            "(config 4's psum merge); bucket-sharded sparse counting is "
            "parallel/bucketed.py"
        )
    k, bins = config.k, config.bins
    batch = int(batch_bases or getattr(config, "batch_bases", 1 << 24))
    pcount = jax.process_count()
    rank = jax.process_index()
    ranges = split_fasta_byte_ranges(path, pcount)
    start, end = ranges[rank % len(ranges)]
    flat, total_bases, n_seqs = encode_range_stream(path, start, end)

    if pcount > 1:
        from jax.experimental import multihost_utils

        lengths = multihost_utils.process_allgather(
            np.array([flat.shape[0]], dtype=np.int64)
        )
        max_len = int(np.max(lengths))
    else:
        max_len = int(flat.shape[0])
    n_steps = max(-(-max_len // batch), 1)
    n_local = max(mesh.shape[axis] // max(pcount, 1), 1)
    slab = batch + k  # + (k-1) halo + >=1 guaranteed trailing INVALID
    slab += (-slab) % n_local
    sharding = NamedSharding(mesh, P(axis))

    # ---- resume: newest step every process has a valid checkpoint for ---
    hist = np.zeros(bins, dtype=np.int64)
    first_step = 0
    if checkpoint_path:
        ck, first_step = _common_resume_step(
            checkpoint_path, rank, pcount, batch, max_len, config,
            want_dense=True,
        )
        if ck is not None:
            hist = ck.hist.astype(np.int64)

    steps_done = first_step
    for step in range(first_step, n_steps):
        if max_steps is not None and steps_done - first_step >= max_steps:
            break
        lo = step * batch
        seg = flat[lo : lo + batch + k - 1]
        buf = np.full(slab, INVALID, dtype=np.uint8)
        buf[: seg.shape[0]] = seg
        if pcount == 1:
            garr = jax.device_put(buf, sharding)
        else:
            garr = jax.make_array_from_process_local_data(
                sharding, buf, (slab * pcount,)
            )
        h = sc.count_sharded(garr, k, bins, config.canonical, mesh, axis)
        hist += np.asarray(h, dtype=np.int64)
        steps_done = step + 1
        if checkpoint_path:
            ckpt_mod.save_checkpoint(
                _ckpt_file(checkpoint_path, rank, steps_done % 2),
                ckpt_mod.CountCheckpoint(
                    k=k,
                    canonical=config.canonical,
                    cursor=steps_done * batch,
                    total_bases=max_len,
                    hist=hist,
                ),
            )
    return hist, total_bases, n_seqs, steps_done, n_steps


def _common_resume_step(
    checkpoint_path: str,
    rank: int,
    pcount: int,
    batch: int,
    max_len: int,
    config,
    want_dense: bool,
):
    """Two-generation resume: newest step EVERY process has a valid
    checkpoint for (a kill can interleave saves across processes by at
    most one step; the older generation covers the rollback). Returns
    (checkpoint | None, first_step)."""
    from dna_kmeres_parallel.utils import checkpoint as ckpt_mod

    mine = {}
    for gen in (0, 1):
        try:
            ck = ckpt_mod.load_checkpoint(
                _ckpt_file(checkpoint_path, rank, gen)
            )
        except Exception:
            continue
        # cursor is in BASES (steps_done * batch at save time), so a
        # resume with a different batch size is accepted only when it
        # divides the saved progress cleanly.
        if (
            ck.dense == want_dense
            and ck.k == config.k
            and ck.canonical == config.canonical
            and ck.total_bases == max_len
            and ck.cursor % batch == 0
        ):
            mine[ck.cursor] = ck
    have = np.zeros(2, dtype=np.int64)
    for i, s in enumerate(sorted(mine, reverse=True)[:2]):
        have[i] = s
    if pcount > 1:
        from jax.experimental import multihost_utils

        all_have = multihost_utils.process_allgather(have)
    else:
        all_have = have[None, :]
    for s in sorted(mine, reverse=True):
        if s and all(
            s in set(row.tolist()) for row in np.atleast_2d(all_have)
        ):
            return mine[s], s // batch
    return None, 0


def count_file_bucketed_multihost_resumable(
    path: str,
    config,
    mesh,
    axis: str = "data",
    checkpoint_path: str | None = None,
    batch_bases: int | None = None,
    max_steps: int | None = None,
    owner_mode: str = "prefix",
):
    """Batched, checkpointed BUCKET-SHARDED sparse count — config 5's
    longest-running pod scenario (k up to 31, all_to_all code exchange)
    with the same preemption-survival contract as the dense path
    (SURVEY.md §5: "resume-from-last-merged" state + stream cursor).

    Per globally-agreed step s, every process slices its record-aligned
    range's [s*batch, s*batch + batch + k - 1) slab, splits it across its
    LOCAL devices with (k-1) halos, and runs the bucket-sharded exchange
    over the full mesh (parallel/bucketed.count_bucket_sharded). Each
    process then compacts ONLY its own devices' sub-tables (owners
    partition the code space, so per-process tables are disjoint) and
    merges them into its running per-owner partial table. After each step
    the (cursor, local sparse table) pair is saved atomically under the
    dense path's TWO-GENERATION protocol; a restart resumes from the
    newest step every process has on disk. Integer merges make the
    resumed per-process tables bit-identical to a single-shot run.

    Returns (codes_u64, counts_i64, total_bases, n_seqs, steps_done,
    n_steps) — codes/counts are THIS process's owner partition; the
    global table is the disjoint merge of all processes' results.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dna_kmeres_parallel.models.sparse_engine import (
        merge_sparse_tables,
    )
    from dna_kmeres_parallel.ops.encode import INVALID
    from dna_kmeres_parallel.parallel import bucketed
    from dna_kmeres_parallel.utils import checkpoint as ckpt_mod

    k = config.k
    batch = int(batch_bases or getattr(config, "batch_bases", 1 << 24))
    pcount = jax.process_count()
    rank = jax.process_index()
    D = mesh.shape[axis]
    n_local = max(D // max(pcount, 1), 1)
    ranges = split_fasta_byte_ranges(path, pcount)
    start, end = ranges[rank % len(ranges)]
    flat, total_bases, n_seqs = encode_range_stream(path, start, end)

    if pcount > 1:
        from jax.experimental import multihost_utils

        lengths = multihost_utils.process_allgather(
            np.array([flat.shape[0]], dtype=np.int64)
        )
        max_len = int(np.max(lengths))
    else:
        max_len = int(flat.shape[0])
    n_steps = max(-(-max_len // batch), 1)
    span = max(-(-batch // n_local), 1)  # owned windows per local shard
    halo = k - 1
    sharding2 = NamedSharding(mesh, P(axis, None))
    sharding1 = NamedSharding(mesh, P(axis))

    codes = np.zeros(0, np.uint64)
    counts = np.zeros(0, np.int64)
    first_step = 0
    if checkpoint_path:
        ck, first_step = _common_resume_step(
            checkpoint_path, rank, pcount, batch, max_len, config,
            want_dense=False,
        )
        if ck is not None:
            codes = ck.sparse_codes.astype(np.uint64)
            counts = ck.sparse_counts.astype(np.int64)

    steps_done = first_step
    for step in range(first_step, n_steps):
        if max_steps is not None and steps_done - first_step >= max_steps:
            break
        lo_b = step * batch
        seg = flat[lo_b : lo_b + batch + halo]
        # Local shard grid [n_local, span + halo]: row r owns windows
        # starting in [r*span, (r+1)*span) of this step's batch; the halo
        # (and any short tail) is INVALID-guarded.
        local = np.full((n_local, span + halo), INVALID, dtype=np.uint8)
        n_own_local = np.zeros(n_local, dtype=np.int32)
        for r in range(n_local):
            s0 = r * span
            piece = seg[s0 : s0 + span + halo]
            local[r, : piece.shape[0]] = piece
            n_own_local[r] = int(np.clip(batch - s0, 0, span))
        if pcount == 1:
            inputs = jax.device_put(local, sharding2)
        else:
            inputs = jax.make_array_from_process_local_data(
                sharding2, local, (D, span + halo)
            )
        if pcount == 1:
            n_own_g = jax.device_put(n_own_local, sharding1)
        else:
            n_own_g = jax.make_array_from_process_local_data(
                sharding1, n_own_local, (D,)
            )
        hi, lo_w, cnt, starts, overflow = bucketed.count_bucket_sharded(
            inputs, n_own_g, k, config.canonical, mesh, axis,
            owner_mode=owner_mode,
        )
        if bool(overflow):
            raise RuntimeError(
                "bucketed send capacity overflow — re-run with a smaller "
                "batch_bases (capacity scales with the per-step window "
                "count)"
            )
        # Compact ONLY this process's devices' sub-tables (disjoint owner
        # partition) and fold them into the running local table.
        local_rows = []
        for arr in (hi, lo_w, cnt, starts):
            shards = sorted(
                arr.addressable_shards, key=lambda s: s.index[0].start or 0
            )
            local_rows.append(
                np.concatenate([np.asarray(s.data) for s in shards], axis=0)
            )
        step_codes, step_counts = bucketed.gather_table(*local_rows)
        codes, counts = merge_sparse_tables(
            [(codes, counts), (step_codes, step_counts)]
        )
        steps_done = step + 1
        if checkpoint_path:
            ckpt_mod.save_checkpoint(
                _ckpt_file(checkpoint_path, rank, steps_done % 2),
                ckpt_mod.CountCheckpoint(
                    k=k,
                    canonical=config.canonical,
                    cursor=steps_done * batch,
                    total_bases=max_len,
                    sparse_codes=codes,
                    sparse_counts=counts,
                ),
            )
    return codes, counts, total_bases, n_seqs, steps_done, n_steps


def distance_file_multihost_resumable(
    path: str,
    config,
    output_path: str,
    checkpoint_path: str | None = None,
    panel_rows: int = 2048,
    max_panels: int | None = None,
    stitch: bool = True,
) -> dict:
    """Multi-host pairwise distances with resume (r5 — VERDICT missing
    #2: distances scale out like counting does).

    Ownership is by ROW RANGE over the packed strict-upper-triangle
    result: process p streams the contiguous row block
    balanced_row_splits(S, P)[p] — blocks are pair-balanced, since row i
    has S-1-i partners — to its own shard file
    ``{output}.part{p}`` under the shared resumable writer
    (models/distance_stream.py: per-process checkpoint
    ``{checkpoint}.p{p}``, fsync-then-checkpoint durability,
    byte-identical resume). Every process ingests the full (record-
    aligned) input — distances are all-vs-all, so each row block needs
    every partner's table — and the regime routes exactly like the
    single-process CLI: dense counts-matrix panels for small k, sparse
    tables / union-indexed device panels past it
    (/root/reference/main.cu:215-399 is the program this scales out).

    After its block completes, each process allgathers completion flags
    (the barrier doubles as the failure detector); when ALL blocks are
    done, rank 0 stitches the shards in rank order into ``output_path``
    (concatenation == the single-process byte stream) via an atomic
    rename, so a kill during the stitch re-runs it idempotently.

    max_panels bounds panels processed per call (preemption simulation
    in tests). Returns this process's report + global completion."""
    import jax

    from dna_kmeres_parallel.models import distance_stream
    from dna_kmeres_parallel.models.sparse_engine import (
        dense_distance_preferred,
        distance_sparse_stream_to_csv,
    )
    from dna_kmeres_parallel.ops.encode import MAX_DENSE_K
    from dna_kmeres_parallel.utils import fasta

    pcount = jax.process_count()
    rank = jax.process_index()
    records = fasta.parse_fasta(path)
    seqs = [r.seq for r in records]
    S = len(seqs)
    splits = distance_stream.balanced_row_splits(S, pcount)
    lo, hi = splits[rank % len(splits)]
    part = f"{output_path}.part{rank}"
    ck = f"{checkpoint_path}.p{rank}" if checkpoint_path else None
    k = config.k
    if k <= MAX_DENSE_K and dense_distance_preferred(
        S, k, [len(s) for s in seqs]
    ):
        from dna_kmeres_parallel.models.engine import KmerEngine

        report = KmerEngine(config).distance_stream_to_csv(
            seqs,
            part,
            panel_rows=panel_rows,
            checkpoint_path=ck,
            max_panels=max_panels,
            row_lo=lo,
            row_hi=hi,
        )
        report["regime"] = "dense"
    else:
        report = distance_sparse_stream_to_csv(
            seqs,
            k,
            part,
            config.canonical,
            panel_rows=panel_rows,
            checkpoint_path=ck,
            max_panels=max_panels,
            row_lo=lo,
            row_hi=hi,
        )
        report["regime"] = "sparse"
    done = np.array([1 if report["completed"] else 0], dtype=np.int64)
    if pcount > 1:
        from jax.experimental import multihost_utils

        all_done = multihost_utils.process_allgather(done)
    else:
        all_done = done[None, :]
    complete = bool(np.all(np.atleast_2d(all_done)))
    report["all_complete"] = complete
    report["rows"] = [int(lo), int(hi)]
    if complete and stitch and rank == 0:
        tmp = str(output_path) + ".stitch.tmp"
        with open(tmp, "wb") as out_f:
            for p in range(len(splits)):
                with open(f"{output_path}.part{p}", "rb") as in_f:
                    while True:
                        chunk = in_f.read(1 << 24)
                        if not chunk:
                            break
                        out_f.write(chunk)
            out_f.flush()
            os.fsync(out_f.fileno())
        os.replace(tmp, output_path)
        report["output"] = str(output_path)
    return report


def count_file_multihost(path: str, config, mesh, axis: str = "data"):
    """Each host counts its record-aligned range; psum merges over the mesh.

    Returns the replicated dense histogram as np.int64. (Dense k only —
    the bucket-sharded sparse path is parallel/bucketed.py.)
    """
    import jax

    from dna_kmeres_parallel.parallel import sharded_count as sc

    ranges = split_fasta_byte_ranges(path, jax.process_count())
    start, end = ranges[jax.process_index() % len(ranges)]
    flat, total_bases, n_seqs = encode_range_stream(path, start, end)
    stream = make_global_stream(flat, mesh, axis)
    hist = sc.count_sharded(
        stream, config.k, config.bins, config.canonical, mesh, axis
    )
    return np.asarray(hist, dtype=np.int64), total_bases, n_seqs
