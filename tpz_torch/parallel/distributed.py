"""Span sharding, manifest and resume, and multi-process start-up (port
of tpz/parallel/distributed.py).

- Spans: the input is cut into independent spans; gzip members and bzip2
  streams concatenate losslessly, so each span's output stands alone and
  their concatenation in order is one valid stream.
- Manifest and resume: with a work directory, each span's output is
  written as span_<i>.bin and manifest.json records span -> index,
  offset, length, out_size, crc32; a later call skips the spans already
  written, so a job restarts at span granularity.
- Processes: process p of P takes the spans i with i % P == p;
  `init_distributed` joins a torch.distributed process group (the
  reference's `maybe_init_distributed` joins jax.distributed from
  TPZ_COORD, TPZ_NPROCS and TPZ_PROC_ID; the port reads no environment
  variable and takes them as arguments).

Process 0 assembles as soon as its own spans are written: with real
processes it raises "span i incomplete" unless the caller has waited for
the others first (a `torch.distributed.barrier()` between the other
processes' calls and process 0's), as the reference's semantics are
kept. Processes that share one card (two ranks on cuda:0) run their
encodes one after another on it, as a process's spans do in its one
compress_many call: sharding on one card buys no speed.
"""

from __future__ import annotations

import json
import os
import zlib as _zlib
from dataclasses import asdict, dataclass

import torch
import torch.distributed as dist

from tpz_torch import api

SPAN_BYTES_DEFAULT = 1 << 24  # 16 MiB a work item

#: formats whose streams concatenate losslessly (standalone members)
CONCAT_FORMATS = ("gzip", "bzip2")


def init_distributed(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, backend: str | None = None,
                     device="cuda") -> tuple[int, int]:
    """Join the process group at tcp://`coordinator` ("host:port") as
    rank `process_id` of `num_processes` when a coordinator is given and
    no group is up (the reference's maybe_init_distributed,
    tpz/parallel/distributed.py:40). backend None picks "nccl" for a
    CUDA `device` and "gloo" for the CPU. Returns (rank, world size):
    (0, 1) without a group."""
    if coordinator and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class SpanResult:
    index: int
    offset: int
    length: int
    out_size: int
    crc32: int


def spans_for(n: int, span_bytes: int = SPAN_BYTES_DEFAULT):
    return [(i, off, min(span_bytes, n - off))
            for i, off in enumerate(range(0, max(n, 1), span_bytes))]


def compress_sharded(
    data: bytes,
    format: str = "gzip",
    level: int = 6,
    device="cuda",
    span_bytes: int = SPAN_BYTES_DEFAULT,
    work_dir: str | None = None,
    process_index: int = 0,
    process_count: int = 1,
    fail_spans: set[int] | None = None,
) -> bytes | None:
    """Data-parallel compression over independent spans (the reference's
    compress_sharded, tpz/parallel/distributed.py:69).

    This process's pending spans are encoded in one
    tpz_torch.api.compress_many call on `device`. With work_dir, each
    span's output persists as span_<i>.bin and manifest.json records the
    ordered-concat recipe; spans already written are skipped on a re-run.
    Process `process_index` of `process_count` takes the spans i with
    i % process_count == process_index; only process 0 returns the
    assembled stream (the others return None once their spans are
    written).

    fail_spans is the fault-injection hook: the listed spans are skipped
    as if their host died, and process 0's assembly then raises; a later
    call without it completes them."""
    if format not in CONCAT_FORMATS:
        raise ValueError(
            f"sharded compression needs a concatenable container; "
            f"{format!r} not in {CONCAT_FORMATS}")
    spans = spans_for(len(data), span_bytes)
    results: dict[int, bytes] = {}
    manifest_path = (os.path.join(work_dir, "manifest.json") if work_dir
                     else None)
    manifest: dict[str, dict] = {}
    if manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    pending = []
    for i, off, ln in spans:
        if i % process_count != process_index and work_dir is None:
            raise ValueError("multi-process mode requires work_dir")
        if i % process_count != process_index:
            continue
        span_file = (os.path.join(work_dir, f"span_{i}.bin") if work_dir
                     else None)
        meta = manifest.get(str(i))
        if span_file and meta and os.path.exists(span_file):
            with open(span_file, "rb") as f:
                blob = f.read()
            if (len(blob) == meta["out_size"]
                    and _zlib.crc32(blob) == meta["crc32"]):
                results[i] = blob
                continue  # resume: span already done
        if fail_spans and i in fail_spans:
            continue  # injected fault: this span's host "died"
        pending.append((i, off, ln))
    if pending:
        blobs = api.compress_many(
            [data[off:off + ln] for _, off, ln in pending], format,
            level=level, device=device)
        for (i, off, ln), blob in zip(pending, blobs):
            results[i] = blob
            if work_dir:
                with open(os.path.join(work_dir, f"span_{i}.bin"), "wb") as f:
                    f.write(blob)
                manifest[str(i)] = asdict(SpanResult(
                    i, off, ln, len(blob), _zlib.crc32(blob)))
        if work_dir:
            with open(manifest_path, "w") as f:
                json.dump(manifest, f)

    if process_count > 1 and process_index != 0:
        return None
    # Ordered concat (process 0 / single process). Missing spans mean a
    # fault: the caller re-runs (resume path) until complete.
    out = bytearray()
    for i, off, ln in spans:
        if i in results:
            out += results[i]
            continue
        if work_dir:
            span_file = os.path.join(work_dir, f"span_{i}.bin")
            if os.path.exists(span_file):
                with open(span_file, "rb") as f:
                    out += f.read()
                continue
        raise RuntimeError(f"span {i} incomplete (failed host?); re-run to "
                           f"resume from manifest")
    return bytes(out)
