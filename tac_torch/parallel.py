"""Batched corpus encode and decode on one device, and sharded across
processes (counterpart of tac/parallel.py).

The packed encoder and decoder (``family``) take leading axes ([..., C, T]
and [..., C, F, W32]): the fixed-rate and block-switch families flatten
them into one frame-row axis, the VBR families into reservoir lanes (each
channel, or each mid/side pair, of each clip its own chain from fill 0),
so a batch [B, C, T] gives every clip the words of a solo encode.

Across processes (``torch.distributed``), one rank per process and one
card per rank; the ranks form a ``Mesh`` over ("clips", "frames"), rank r
at (r // n_frames, r % n_frames), as tac's device mesh:

  * clips axis (data parallelism): ``shard_clips`` scatters a host batch
    from one rank, each rank encodes or decodes its shard with the
    single-device entries (no collective inside), ``gather_clips`` brings
    the results back. Together these two stand for tac's
    ``device_put(NamedSharding(P("clips")))`` and ``np.asarray`` of a
    sharded array;
  * frames axis (sequence parallelism): ``decode_batch_sharded`` decodes
    a slice of the frame axis per rank; the overlap-add couples adjacent
    frames by one half-frame, so each rank sends its dangling tail to the
    next frames-rank (one non-wrapping send) and ``gather_frames`` joins
    the rows;
  * metrics: ``corpus_metrics_sharded`` sums (Σ SNR, count) with one
    ``all_reduce`` over the clips axis.

NCCL moves CUDA tensors; gloo's scatter, gather and send / recv take CPU
tensors only, so under gloo what a collective moves goes through host
memory (``_wire``). The compute stays on the rank's device either way.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from tac_torch import codec, family, tracing
from tac_torch.codec import FrameCode
from tac_torch.config import CodecConfig, resolve_device

# Every process group's timeout: a rank that dies leaves the others a
# bounded wait, never a hang.
TIMEOUT = datetime.timedelta(minutes=5)


def encode_batch(x, cfg: CodecConfig, device=None) -> FrameCode:
    """x: float [B, C, T] → FrameCode [B, C, F, ...] (tac's encode_batch)."""
    return codec.encode_clip(x, cfg, device)


def encode_batch_packed(x, cfg: CodecConfig, device=None):
    """Batched packed encode on `device` (CUDA unless named). x: float
    [B, C, T] → (words int32 [B, C, F, W32] holding 32-bit patterns, nbits
    int64 [B, C, F])."""
    with tracing.span("tac.encode"):
        return family.encode_clip_packed(x, cfg, device)


def to_pcm16(y: torch.Tensor) -> torch.Tensor:
    """16-bit PCM on y's device with write_wav's rounding (half to even,
    clipped): the pull to the host is a quarter of f64's, half of f32's."""
    return torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(torch.int16)


def decode_batch_packed(words, cfg: CodecConfig, t: int,
                        pcm16: bool = False, device=None):
    """Batched packed decode, the mirror of ``encode_batch_packed``: payload
    rows int32 [B, C, F, W32] → [B, C, T] on `device` (CUDA unless named).
    The family comes from cfg. pcm16=True quantizes to int16 on the device
    (``to_pcm16``)."""
    y = family.decode_clip_packed(words, cfg, t, device)
    return to_pcm16(y) if pcm16 else y


# ------------------------------------------------------ the process mesh ---

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ("clips", "frames") mesh of processes and the
    process groups it needs: `group` (every rank, `backend`: scatters and
    gathers), `clips_group` (the ranks of this rank's frames index: the
    metric sums), `frames_group` (the ranks of this rank's clips index: the
    halo) and `host_group` (every rank, gloo: control messages and flags).
    """
    shape: dict                 # {"clips": n_clips, "frames": n_frames}
    rank: int
    clip_index: int
    frame_index: int
    device: torch.device
    backend: str
    group: object
    clips_group: object
    frames_group: object
    host_group: object


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> int:
    """Bring up the default process group (tac's init_distributed) from
    explicit arguments, or from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT) when they are absent; with neither, a no-op
    for one process. The default group only carries the rendezvous (gloo):
    ``make_mesh`` builds the groups that move data, with its own backend.
    Returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and world_size is None \
            and "RANK" not in os.environ:
        return 1
    dist.init_process_group(
        "gloo", init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=TIMEOUT)
    return dist.get_world_size()


def make_mesh(n_clips: Optional[int] = None, n_frames: int = 1,
              backend: Optional[str] = None, device=None) -> Mesh:
    """The ("clips", "frames") mesh over every rank of the default group
    (tac's make_mesh): rank r at (r // n_frames, r % n_frames); n_clips
    defaults to the world size over n_frames. The rank's device is
    ``cuda:{LOCAL_RANK % device_count}`` unless named; the backend is NCCL
    for CUDA devices and gloo for the CPU unless named. NCCL runs no two
    ranks of one communicator on one card: where it would, this raises
    (on one card, pass backend="gloo")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_clips is None:
        n_clips = world // n_frames
    if n_clips < 1 or n_frames < 1 or n_clips * n_frames != world:
        raise ValueError(f"a {n_clips} x {n_frames} mesh needs "
                         f"{n_clips * n_frames} ranks; the world has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    host = dist.new_group(list(range(world)), backend="gloo",
                          timeout=TIMEOUT)
    if backend == "nccl":
        where = [None] * world
        dist.all_gather_object(where, (socket.gethostname(), str(dev)),
                               group=host)
        if dev.type != "cuda" or len(set(where)) < world:
            raise ValueError(
                f"NCCL needs each rank on a card of its own; the ranks sit "
                f"on {where}. Give each rank its own card, or pass "
                "backend='gloo'")
        torch.cuda.set_device(dev)

    def groups(rank_lists):
        mine = None
        for ranks in rank_lists:            # every rank makes every group
            g = dist.new_group(ranks, backend=backend, timeout=TIMEOUT)
            if rank in ranks:
                mine = g
        return mine

    return Mesh(
        shape={"clips": n_clips, "frames": n_frames}, rank=rank,
        clip_index=rank // n_frames, frame_index=rank % n_frames,
        device=dev, backend=backend,
        group=groups([list(range(world))]),
        clips_group=groups([list(range(f, world, n_frames))
                            for f in range(n_frames)]),
        frames_group=groups([list(range(c * n_frames, (c + 1) * n_frames))
                             for c in range(n_clips)]),
        host_group=host)


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t as the bytes a collective of the mesh's backend moves: on the
    rank's card under NCCL, in host memory under gloo (whose scatter,
    gather and send / recv take CPU tensors only), as uint8 (neither
    backend moves int16)."""
    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    return t.to(where).contiguous().view(torch.uint8)


def _gather(y: torch.Tensor, mesh: Mesh, dst: int):
    """Every rank's y (one shape and type on all) → their list by rank on
    rank dst, on dst's device; None on the other ranks."""
    buf = _wire(y, mesh)
    parts = ([torch.empty_like(buf) for _ in range(dist.get_world_size())]
             if mesh.rank == dst else None)
    dist.gather(buf, parts, dst=dst, group=mesh.group)
    if parts is None:
        return None
    return [p.view(y.dtype).to(mesh.device) for p in parts]


def shard_clips(x, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Scatter a batch [B, ...] that rank `src` holds (x is ignored on the
    other ranks) over the mesh's clips axis: clips index i gets clips
    [i·b, (i + 1)·b), b = ⌈B / n_clips⌉, the last shard padded with zero
    clips; every rank of a clips row gets its row's shard. Returns the
    local shard on the rank's device."""
    meta = [None]
    if mesh.rank == src:
        x = torch.as_tensor(x)
        meta = [(tuple(x.shape), x.dtype)]
    dist.broadcast_object_list(meta, src=src, group=mesh.host_group)
    shape, dtype = meta[0]
    n, m = mesh.shape["clips"], mesh.shape["frames"]
    b = -(-shape[0] // n)
    buf = _wire(torch.empty((b, *shape[1:]), dtype=dtype), mesh)
    parts = None
    if mesh.rank == src:
        padded = torch.zeros((n * b, *shape[1:]), dtype=dtype,
                             device=x.device)
        padded[:shape[0]] = x
        shards = [_wire(s, mesh) for s in padded.split(b)]
        parts = [shards[r // m] for r in range(n * m)]
    dist.scatter(buf, parts, src=src, group=mesh.group)
    return buf.view(dtype).to(mesh.device)


def gather_clips(y: torch.Tensor, mesh: Mesh, dst: int = 0,
                 n: Optional[int] = None):
    """The mirror of ``shard_clips``: each rank's local result [b, ...] →
    the batch [n_clips·b, ...] on rank dst's device (its first n clips
    when n is given: the pad clips dropped); None on the other ranks. The
    copies that the frames ranks of a clips row hold are taken once."""
    parts = _gather(y, mesh, dst)
    if parts is None:
        return None
    return torch.cat(parts[::mesh.shape["frames"]])[:n]


def encode_batch_packed_sharded(x, cfg: CodecConfig, mesh: Mesh):
    """The packed encode of this rank's clip shard (``shard_clips``) on its
    device: pure data parallelism, no collective; the words stay local
    until ``gather_clips``. x: float [b, C, T] → (words, nbits) as
    ``encode_batch_packed``."""
    return encode_batch_packed(x, cfg, mesh.device)


def decode_batch_packed_sharded(words, cfg: CodecConfig, t: int, mesh: Mesh,
                                pcm16: bool = False):
    """The packed decode of this rank's shard of payload rows [b, C, F,
    W32] on its device, no collective: [b, C, T] as
    ``decode_batch_packed``."""
    return decode_batch_packed(words, cfg, t, pcm16=pcm16,
                               device=mesh.device)


def encode_batch_sharded(x, cfg: CodecConfig, mesh: Mesh) -> FrameCode:
    """The FrameCode encode (``codec.encode_clip``) of this rank's clip
    shard [b, C, T] on its device, no collective: leaves [b, C, F, ...]."""
    return codec.encode_clip(x, cfg, mesh.device)


def _exchange_tail(tail: torch.Tensor, mesh: Mesh):
    """Send this rank's dangling overlap-add tail to frames index + 1 and
    receive the one of frames index − 1, in one batch of point-to-point
    operations (non-wrapping: the first frames rank receives nothing, the
    last sends nothing). Returns what arrived, or None."""
    f, m = mesh.frame_index, mesh.shape["frames"]
    ops, recv = [], None
    if f + 1 < m:
        ops.append(dist.P2POp(dist.isend, _wire(tail, mesh), mesh.rank + 1,
                              mesh.frames_group))
    if f > 0:
        recv = torch.empty_like(_wire(tail, mesh))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank - 1,
                              mesh.frames_group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return None if recv is None else recv.view(tail.dtype).to(mesh.device)


def _overlap_add_halo(y: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Frame-axis-sharded overlap-add (tac's _overlap_add_halo): this rank's
    decoded frames [..., F_loc, 2H] → its output rows [..., F_loc, H]. The
    last row's second half belongs to the next frames rank's first row."""
    first, second = y[..., :h], y[..., h:]
    zero = torch.zeros_like(first[..., :1, :])
    acc = (torch.cat([first, zero], dim=-2)
           + torch.cat([zero, second], dim=-2))            # [..., F_loc+1, H]
    out = acc[..., :-1, :]
    recv = _exchange_tail(acc[..., -1:, :], mesh)
    if recv is not None:
        out = torch.cat([out[..., :1, :] + recv, out[..., 1:, :]], dim=-2)
    return out


def decode_batch_sharded(code: FrameCode, cfg: CodecConfig, t: int,
                         mesh: Mesh) -> torch.Tensor:
    """Clips × frames decode (tac's decode_batch_sharded): code is this
    rank's clip shard, leaves [b, C, F, ...] (as ``shard_clips`` or
    ``encode_batch_sharded`` leave it). The frame axis is zero-padded to a
    multiple of the frames axis (zero frames decode to silence) and this
    rank decodes its slice, F_loc = ⌈F / n_frames⌉ frames, with the halo.
    Returns the local rows [b, C, F_loc, H]; ``gather_frames`` gives the
    audio [B, C, T]."""
    m = mesh.shape["frames"]
    code = FrameCode(*(torch.as_tensor(v).to(mesh.device) for v in code))
    f = code.ovs.shape[2]
    f_loc = -(-f // m)
    lo = mesh.frame_index * f_loc

    def local(leaf):
        pad = torch.zeros((*leaf.shape[:2], f_loc * m - f, *leaf.shape[3:]),
                          dtype=leaf.dtype, device=leaf.device)
        return torch.cat([leaf, pad], dim=2)[:, :, lo:lo + f_loc]

    c = codec.make_consts(cfg, mesh.device)
    y = codec.decode_frame(FrameCode(*map(local, code)), cfg, c)
    return _overlap_add_halo(y, cfg.n_mdct_lines, mesh)


def gather_frames(rows: torch.Tensor, mesh: Mesh, t: int, dst: int = 0,
                  n: Optional[int] = None):
    """``decode_batch_sharded``'s local rows [b, C, F_loc, H] of every rank
    → the audio [B, C, T] on rank dst's device (its first n clips when n
    is given); None on the other ranks."""
    parts = _gather(rows, mesh, dst)
    if parts is None:
        return None
    m, h = mesh.shape["frames"], rows.shape[-1]
    out = torch.cat([torch.cat(parts[i:i + m], dim=-2)
                     for i in range(0, len(parts), m)])  # [B, C, F_pad, H]
    return out.reshape(*out.shape[:-2], -1)[..., h:h + t][:n]


def corpus_metrics_sharded(x, y, mesh: Mesh):
    """Per-clip SNR (dB) of this rank's shard, x and y [b, C, T], and the
    mean over the whole corpus from one all_reduce of (Σ SNR, count) over
    the clips axis (tac's psum). Returns (mean: float, local snr [b])."""
    xs = torch.as_tensor(x).to(mesh.device)
    ys = torch.as_tensor(y).to(mesh.device)
    err = ((xs - ys) ** 2).mean(dim=(1, 2))
    sig = (xs ** 2).mean(dim=(1, 2))
    snr = 10.0 * torch.log10(sig.clamp_min(1e-30) / err.clamp_min(1e-30))
    total = torch.stack([snr.double().sum(),
                         torch.tensor(float(snr.shape[0]), dtype=torch.float64,
                                      device=snr.device)])
    wire = total.to(mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(wire, group=mesh.clips_group)
    return float(wire[0] / wire[1]), snr
