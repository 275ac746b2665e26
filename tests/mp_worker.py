"""Subprocess worker for the true multi-process multihost test.

Runs one 'host' of a 2-process jax.distributed CPU job (gloo collectives)
and counts its record-aligned byte range of a shared FASTA through
count_file_multihost — the exact config-4 code path (per-host ingest,
make_array_from_process_local_data, psum merge over the global mesh).

Usage: python mp_worker.py <pid> <nprocs> <port> <fasta> <k> <out.npz>
"""

import os
import sys


def main() -> int:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    fasta_path, k, out_path = sys.argv[4], int(sys.argv[5]), sys.argv[6]

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from dna_kmeres_parallel.parallel import multihost

    multihost.init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs

    import numpy as np
    from jax.sharding import Mesh

    from dna_kmeres_parallel.utils.config import KmerConfig

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("data",))
    mode = sys.argv[7] if len(sys.argv) > 7 else "dense"
    if mode == "dense":
        hist, total_bases, n_seqs = multihost.count_file_multihost(
            fasta_path, KmerConfig(k=k), mesh
        )
        np.savez(out_path, hist=hist, total_bases=total_bases, n_seqs=n_seqs)
        return 0

    if mode.startswith("resumable"):
        # Checkpointed multi-host dense count. "resumable:<ckpt>:<batch>"
        # runs to completion; "resumable_kill:<ckpt>:<batch>:<steps>" stops
        # after <steps> steps (preemption simulation) — a later
        # "resumable" invocation must pick up from the common checkpoint
        # and produce the identical histogram.
        parts = mode.split(":")
        ckpt, batch = parts[1], int(parts[2])
        max_steps = int(parts[3]) if len(parts) > 3 else None
        hist, total_bases, n_seqs, steps_done, n_steps = (
            multihost.count_file_multihost_resumable(
                fasta_path,
                KmerConfig(k=k),
                mesh,
                checkpoint_path=ckpt,
                batch_bases=batch,
                max_steps=max_steps,
            )
        )
        np.savez(
            out_path,
            hist=hist,
            total_bases=total_bases,
            n_seqs=n_seqs,
            steps_done=steps_done,
            n_steps=n_steps,
        )
        return 0

    if mode.startswith("bktresume"):
        # Checkpointed bucket-sharded sparse count (config 5 + resume).
        # "bktresume:<ckpt>:<batch>" runs to completion;
        # "bktresume_kill:<ckpt>:<batch>:<steps>" stops after <steps>
        # steps. Each process writes ITS OWN owner-partition table; the
        # test merges per-process npz files into the global table.
        parts = mode.split(":")
        ckpt, batch = parts[1], int(parts[2])
        max_steps = int(parts[3]) if len(parts) > 3 else None
        import numpy as np

        codes, counts, total_bases, n_seqs, steps_done, n_steps = (
            multihost.count_file_bucketed_multihost_resumable(
                fasta_path,
                KmerConfig(k=k),
                mesh,
                checkpoint_path=ckpt,
                batch_bases=batch,
                max_steps=max_steps,
            )
        )
        np.savez(
            out_path,
            codes=codes,
            counts=counts,
            total_bases=total_bases,
            n_seqs=n_seqs,
            steps_done=steps_done,
            n_steps=n_steps,
        )
        return 0

    if mode.startswith("dist"):
        # Multi-host distances (r5): row-range ownership over the packed
        # triangle, per-process shard CSV + checkpoint, rank-0 stitch.
        # "dist:<csv_path>:<panel_rows>" runs to completion;
        # "dist:<csv_path>:<panel_rows>:<max_panels>" stops early
        # (preemption simulation) — a later full invocation must resume
        # from the per-process checkpoints and produce a final CSV
        # byte-identical to the single-process run.
        parts = mode.split(":")
        csv_path = parts[1]
        panel_rows = int(parts[2])
        max_panels = int(parts[3]) if len(parts) > 3 else None
        report = multihost.distance_file_multihost_resumable(
            fasta_path,
            KmerConfig(k=k),
            csv_path,
            checkpoint_path=csv_path + ".ckpt",
            panel_rows=panel_rows,
            max_panels=max_panels,
        )
        np.savez(
            out_path,
            n_pairs=report["n_pairs"],
            completed=int(report["completed"]),
            all_complete=int(report["all_complete"]),
            rows=np.array(report["rows"], dtype=np.int64),
        )
        return 0

    # mode == "bucketed": the config-5 all_to_all path over the
    # cross-process mesh. Every process parses the whole (small) file and
    # contributes its device's stream shard; per-device sub-tables are
    # allgathered and merged into the global table.
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dna_kmeres_parallel import native
    from dna_kmeres_parallel.parallel import bucketed

    parsed = native.parse_fasta_native(fasta_path)
    shards, n_own = bucketed.shard_stream_with_halo(parsed.stream, k, mesh)
    D = shards.shape[0]
    me = jax.process_index()
    shards_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data", None)), shards[me : me + 1], shards.shape
    )
    n_own_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), n_own[me : me + 1], n_own.shape
    )
    if mode == "bucketed_raw":
        # The raw-exchange variant: UNSORTED words cross the process
        # boundary over the gloo all_to_all; each process radix-compacts
        # its own device's plane and writes ITS OWN sub-table (owners
        # partition the code space, so the test-side merge of per-process
        # npz files reconstructs the global table exactly).
        from dna_kmeres_parallel.models.sparse_engine import (
            compact_unsorted,
        )

        words, overflow = bucketed.exchange_words_bucket_sharded(
            shards_g, n_own_g, k, False, mesh
        )
        assert not bool(overflow), "bucketed raw send overflow"
        local_plane = tuple(
            np.asarray(w.addressable_shards[0].data)[0] for w in words
        )
        codes_l, counts_l = compact_unsorted(local_plane, k)
        np.savez(
            out_path,
            codes=codes_l,
            counts=counts_l,
            n_seqs=parsed.n_seqs,
            total_bases=parsed.total_bases,
        )
        return 0
    hi, lo, counts, starts, overflow = bucketed.count_bucket_sharded(
        shards_g, n_own_g, k, False, mesh
    )
    # jnp.any over the per-device flags yields a replicated global scalar,
    # readable on every process directly.
    assert not bool(overflow), "bucketed send overflow"
    # Each process holds its own device's row; allgather the rows.
    local = [
        np.asarray(x.addressable_shards[0].data)[0]
        for x in (hi, lo, counts, starts)
    ]
    full = [multihost_utils.process_allgather(jnp.asarray(v)) for v in local]
    codes_u64, counts_np = bucketed.gather_table(*full)
    np.savez(
        out_path,
        codes=codes_u64,
        counts=counts_np,
        n_seqs=parsed.n_seqs,
        total_bases=parsed.total_bases,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
