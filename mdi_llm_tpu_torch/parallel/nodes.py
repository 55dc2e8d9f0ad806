"""Node-topology configs and the multi-process bootstrap of the ring.

Port of `mdi_llm_tpu/parallel/nodes.py` on `torch.distributed`:

- `NodeInfo`, `NodesConfig` and `parse_nodes_config` read both schemas
  as the JAX package does: the reference's `settings_distr/*.json`
  (`nodes.starter{addr, communication.port, device}`,
  `nodes.secondary[i]{...}`; the inference ports are accepted and
  ignored) and the mesh schema (`{"coordinator": "host:port",
  "num_processes": N, "pipeline_stages": S}`).
- `init_distributed` joins process `process_id` (the starter 0, secondary
  i as i+1) to a job of `n_nodes` processes through a TCP store at the
  starter's `addr:comm_port`, with bounded retries, and returns the
  `RingGroup` (None for a single-node config).  The backend follows the
  placement and is never switched after a failure: NCCL when every
  process has a CUDA device of its own, else gloo, with the stage hop
  staged through pinned host buffers (processes sharing one card, or on
  the CPU: the counterpart of the reference's TCP hop).
- `check_params_consistency` all-gathers a strided signature of every
  weight leaf and raises on every process when one differs.
- `broadcast_run_spec` ships the pickled run spec from the starter to
  every process in a `RUN_SPEC_BYTES` buffer; the starter sends
  `{"abort": message}` through the same channel when it refuses a run,
  so no secondary waits on a spec that never comes.

Every process loads the weights itself (`--ckpt` from shared storage, or
random weights from `--seed`); only the run spec travels.
"""

from __future__ import annotations

import datetime
import json
import logging
import pickle
import socket
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Max pickled run-spec size shipped starter -> secondaries (the reference's
# MSGLENGTH analog): 1 MiB is ~250k prompt tokens
RUN_SPEC_BYTES = 1 << 20
# how long a collective or a hop may wait before the process group gives up
# (a peer that died or never came): a hang turns into an error
TIMEOUT_S = 300.0

log = logging.getLogger("mdi_llm_tpu_torch")


@dataclass
class NodeInfo:
    addr: str
    comm_port: int
    device: Optional[str] = None  # per-node device override (node JSON "device")


@dataclass
class NodesConfig:
    starter: NodeInfo
    secondary: List[NodeInfo] = field(default_factory=list)
    pipeline_stages: Optional[int] = None  # None -> one stage per node
    tp_devices: int = 1  # tensor-parallel ranks per stage (the starter's default)

    @property
    def n_nodes(self) -> int:
        return 1 + len(self.secondary)

    @property
    def coordinator(self) -> str:
        return f"{self.starter.addr}:{self.starter.comm_port}"


def _node_from_ref(d: dict, default_port: int) -> NodeInfo:
    comm = d.get("communication", {}) or {}
    return NodeInfo(
        addr=d.get("addr", "127.0.0.1"),
        comm_port=int(comm.get("port", default_port)),
        device=d.get("device"),
    )


def parse_nodes_config(path) -> NodesConfig:
    """Parse the reference `settings_distr` schema or the mesh schema."""
    raw = json.loads(Path(path).read_text())
    if "nodes" in raw:  # reference schema
        nodes = raw["nodes"]
        starter = _node_from_ref(nodes.get("starter", {}), default_port=8088)
        secondary = [
            _node_from_ref(s, default_port=8089 + i)
            for i, s in enumerate(nodes.get("secondary", []) or [])
        ]
        return NodesConfig(
            starter=starter,
            secondary=secondary,
            pipeline_stages=raw.get("pipeline_stages"),
            tp_devices=int(raw.get("tp_devices", 1)),
        )
    coord = raw.get("coordinator", "127.0.0.1:8476")
    addr, _, port = coord.rpartition(":")
    if not addr or not port.isdigit():
        raise SystemExit(f"{path}: \"coordinator\" must be host:port, got {coord!r}")
    n_proc = int(raw.get("num_processes", 1))
    starter = NodeInfo(addr=addr or "127.0.0.1", comm_port=int(port))
    secondary = [NodeInfo(addr="?", comm_port=0) for _ in range(n_proc - 1)]
    return NodesConfig(
        starter=starter,
        secondary=secondary,
        pipeline_stages=raw.get("pipeline_stages"),
        tp_devices=int(raw.get("tp_devices", 1)),
    )


def coordinator_config(coordinator: str, num_processes: int) -> NodesConfig:
    """The mesh schema's config from `--coordinator host:port` and
    `--num-processes` (the training CLI's job: process 0 holds the store)."""
    addr, _, port = coordinator.rpartition(":")
    if not addr or not port.isdigit():
        raise SystemExit(f"--coordinator must be host:port, got {coordinator!r}")
    if num_processes < 1:
        raise SystemExit(f"--num-processes must be >= 1, got {num_processes}")
    return NodesConfig(starter=NodeInfo(addr=addr, comm_port=int(port)),
                       secondary=[NodeInfo(addr="?", comm_port=0)
                                  for _ in range(num_processes - 1)])


def node_device(device, process_id: int) -> torch.device:
    """A process's device: "cuda" without an index takes card
    `process_id % device_count`, so processes of one host spread over its
    cards and share them when there are fewer cards than processes."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def choose_backend(idents: List[str]) -> str:
    """NCCL when every process has a CUDA device of its own (`idents`:
    "host|device" per process), else gloo."""
    cuda = all(i.split("|", 1)[1].startswith("cuda") for i in idents)
    return "nccl" if cuda and len(set(idents)) == len(idents) else "gloo"


class RingGroup:
    """One process's view of the ring's process group: its rank, the world
    size, the backend and the stage hop, with the hop's counters (`hops`,
    `hop_bytes`, `hop_s` and `hop_min_s`: host seconds from the send's
    start to the receive's end, which include waiting for the peer to
    finish its stages; the fastest hop is the nearest to the transfer
    alone)."""

    def __init__(self, rank: int, world: int, backend: str, device: torch.device):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device(device)
        self.comm_device = self.device if backend == "nccl" else torch.device("cpu")
        self._bufs = {}
        self.hops = 0
        self.hop_bytes = 0
        self.hop_s = 0.0
        self.hop_min_s = float("inf")

    def broadcast_object(self, obj):
        """`obj` from rank 0 on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self.comm_device)
        return box[0]

    def _buffer(self, key, n: int) -> torch.Tensor:
        k = (key, n)
        if k not in self._bufs:
            pin = self.backend == "gloo" and self.device.type == "cuda"
            self._bufs[k] = torch.empty(n, dtype=torch.uint8, device=self.comm_device,
                                        pin_memory=pin)
        return self._bufs[k]

    def hop(self, payload: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        """Send the payload (x, sid, pos, valid) leaving this process's last
        stage to the next rank, and receive the one entering its first
        stage from the previous rank: one send/recv of one byte buffer.
        The integers lead (int64-aligned), the activations follow."""
        x, sid, pos, val = payload
        ints = torch.cat([sid.reshape(-1), pos.reshape(-1), val.reshape(-1)]).long()
        packed = torch.cat([ints.view(torch.uint8), x.contiguous().reshape(-1).view(torch.uint8)])
        n = packed.numel()
        t0 = time.perf_counter()
        sbuf, rbuf = self._buffer("send", n), self._buffer("recv", n)
        sbuf.copy_(packed)
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        if self.backend == "nccl":
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, sbuf, nxt),
                                           dist.P2POp(dist.irecv, rbuf, prv)])
        else:
            reqs = [dist.isend(sbuf, nxt), dist.irecv(rbuf, prv)]
        for r in reqs:
            r.wait()
        # a copy: the payload outlives the next hop's receive into rbuf
        got = rbuf.to(self.device, non_blocking=True, copy=True)
        if self.backend == "nccl":
            torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - t0
        self.hops += 1
        self.hop_bytes += n
        self.hop_s += dt
        self.hop_min_s = min(self.hop_min_s, dt)
        n_int = ints.numel()
        ints_r = got[: 8 * n_int].view(torch.int64)
        M = pos.numel()
        x_r = got[8 * n_int:].view(x.dtype).reshape(x.shape)
        return x_r, ints_r[:1], ints_r[1 : 1 + M], ints_r[1 + M :]

    def stats(self) -> dict:
        return {"backend": self.backend, "hops": self.hops, "hop_bytes": self.hop_bytes,
                "hop_ms_mean": 1e3 * self.hop_s / self.hops if self.hops else None,
                "hop_ms_min": 1e3 * self.hop_min_s if self.hops else None}


def init_distributed(
    cfg: NodesConfig, process_id: int, device="cuda", retries: int = 5,
    backoff_s: float = 2.0, timeout_s: float = TIMEOUT_S,
) -> Optional[RingGroup]:
    """Join the job as process `process_id`; None for a single-node config.
    A secondary started before the starter's store is up retries
    (`retries` tries, `backoff_s` apart) instead of dying."""
    if cfg.n_nodes == 1:
        return None
    dev = node_device(device, process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    for attempt in range(retries):
        try:
            store = dist.TCPStore(
                cfg.starter.addr, cfg.starter.comm_port, cfg.n_nodes,
                is_master=process_id == 0, timeout=timeout, wait_for_workers=False,
            )
            break
        except Exception as e:  # noqa: BLE001 — connection errors come in several types
            if attempt == retries - 1:
                raise
            log.warning("distributed init attempt %d/%d failed (%s); retrying in %.0fs",
                        attempt + 1, retries, e, backoff_s)
            time.sleep(backoff_s)
    store.set(f"mdi/device/{process_id}", f"{socket.gethostname()}|{dev}")
    idents = [store.get(f"mdi/device/{r}").decode() for r in range(cfg.n_nodes)]
    backend = choose_backend(idents)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=cfg.n_nodes, timeout=timeout)
    group = RingGroup(process_id, cfg.n_nodes, backend, dev)
    log.warning("process %d of %d on %s: %s backend%s", process_id, cfg.n_nodes, dev, backend,
                ", hop staged through pinned host buffers" if backend == "gloo"
                and dev.type == "cuda" else "")
    return group


def shutdown_distributed() -> None:
    """Leave the process group (a no-op when none was made)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def params_signature(params) -> np.ndarray:
    """One float64 per weight leaf (sorted-key order): the sum of a strided
    subsample of at most ~4096 elements."""
    from mdi_llm_tpu_torch.models.transformer import tree_leaves

    sig = []
    for leaf in tree_leaves(params):
        flat = leaf.detach().reshape(-1)
        stride = max(1, flat.numel() // 4096)
        sig.append(float(flat[::stride].double().sum()))
    return np.asarray(sig, np.float64)


def check_params_consistency(params, group: Optional[RingGroup], rtol: float = 1e-3) -> None:
    """Raise on every process of `group` unless all hold the same weights
    (nodes that random-initialised from different seeds or dtypes, or
    loaded stale checkpoint copies); a no-op without a group."""
    if group is None:
        return
    sig = torch.from_numpy(params_signature(params)).to(group.comm_device)
    gathered = [torch.empty_like(sig) for _ in range(group.world)]
    dist.all_gather(gathered, sig)
    all_sigs = np.stack([g.cpu().numpy() for g in gathered])
    ref = all_sigs[0]
    scale = np.maximum(np.abs(ref), 1.0)
    bad = [p for p in range(1, all_sigs.shape[0])
           if np.any(np.abs(all_sigs[p] - ref) / scale > rtol)]
    if bad:
        raise RuntimeError(
            f"parameter mismatch across processes {bad} vs process 0 — all "
            "nodes must load the same checkpoint (or random-init from the "
            "same seed/dtype)"
        )


def pack_run_spec(spec: dict) -> np.ndarray:
    """The `RUN_SPEC_BYTES` buffer: 4-byte little-endian length, pickle."""
    payload = pickle.dumps(spec)
    if 4 + len(payload) > RUN_SPEC_BYTES:
        raise ValueError(f"run spec too large: {len(payload)} bytes")
    buf = np.zeros(RUN_SPEC_BYTES, np.uint8)
    buf[:4] = np.frombuffer(len(payload).to_bytes(4, "little"), np.uint8)
    buf[4 : 4 + len(payload)] = np.frombuffer(payload, np.uint8)
    return buf


def unpack_run_spec(buf: np.ndarray) -> dict:
    n = int.from_bytes(bytes(buf[:4]), "little")
    return pickle.loads(bytes(buf[4 : 4 + n]))


def broadcast_run_spec(spec: Optional[dict], group: Optional[RingGroup]) -> dict:
    """The run spec (prompt token ids and generation knobs) from the
    starter on every process of `group`: pass the dict on process 0, None
    elsewhere.  Without a group (one process) it is packed and unpacked
    too, so the size limit holds everywhere."""
    if group is None:
        assert spec is not None
        return unpack_run_spec(pack_run_spec(spec))
    if spec is not None:
        buf = torch.from_numpy(pack_run_spec(spec))
    else:
        buf = torch.zeros(RUN_SPEC_BYTES, dtype=torch.uint8)
    buf = buf.to(group.comm_device)
    dist.broadcast(buf, src=0)
    return unpack_run_spec(buf.cpu().numpy())
