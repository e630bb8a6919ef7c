"""Process mesh and runtime bootstrap (port of ``parallel/mesh.py``).

The JAX package runs one SPMD program on every host: each host calls
:func:`initialize_runtime` once and builds a ``jax.sharding.Mesh`` over
every device of the job. Here each process drives one device, so the job
is a ``torch.distributed`` process group whose ranks are the mesh's
positions: :func:`initialize_runtime` starts the group (NCCL between
cards, gloo on the CPU) and :func:`build_mesh` lays the ranks out over
named axes in :data:`AXIS_ORDER`, row-major, as the JAX package reshapes
its device list. Roles (ps/worker/chief) do not exist: every rank holds
the parameters and averages gradients with one all-reduce
(:mod:`.collectives`).

Axis names are the JAX package's: ``"data"`` (data parallelism),
``"model"``, ``"seq"``, ``"expert"``, ``"pipeline"`` and ``"replica"``
(outermost). Training runs on all of them: ``"data"`` (and
``"replica"``), ``"model"`` (Megatron tensor parallelism), ``"seq"`` (ring
or Ulysses attention), ``"expert"`` (mixture-of-experts; it also carries
batch rows under the token-sharded dispatch) and ``"pipeline"`` (GPipe
stages).

The job's mesh is the one :func:`build_mesh` builds without an explicit
``world_size``/``rank``: it becomes the *active* mesh
(:func:`active_mesh`), which the collectives and the models read the way a
JAX function reads the axes its ``shard_map`` binds, and it makes one
``torch.distributed`` subgroup per line of every set of axes of size > 1
(:func:`axis_group`). Ranks along ``"model"``, ``"seq"`` and
``"pipeline"`` hold the same batch rows; only the row axes
(:func:`data_axes`, and ``"expert"`` when a loader asks) split them.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import math
import os
from collections.abc import Mapping, Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# Canonical axis names, in the order they appear in a mesh (outermost first).
AXIS_ORDER = ("replica", "data", "pipeline", "expert", "seq", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape.

    ``axes`` maps axis name -> size. At most one axis may be ``-1``, meaning
    "all remaining ranks". Axes of size 1 are kept.

    Example::

        MeshSpec({"data": -1})                      # pure DP over everything
        MeshSpec({"data": -1, "seq": 4})            # DP x 4-way context parallel
        MeshSpec({"replica": 2, "data": -1})        # 2 slices
    """

    axes: Mapping[str, int]

    def __post_init__(self):
        unknown = [a for a in self.axes if a not in AXIS_ORDER]
        if unknown:
            raise ValueError(
                f"unknown mesh axes {unknown}; expected a subset of {AXIS_ORDER}"
            )
        wild = [a for a, n in self.axes.items() if n == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Return concrete sizes in canonical axis order, filling the -1 axis."""
        fixed = 1
        for a, n in self.axes.items():
            if n != -1:
                if n <= 0:
                    raise ValueError(f"axis {a!r} must be positive or -1, got {n}")
                fixed *= n
        sizes = dict(self.axes)
        wild = [a for a, n in self.axes.items() if n == -1]
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {dict(self.axes)} needs {fixed} devices, have {n_devices}"
            )
        return {a: sizes[a] for a in AXIS_ORDER if a in sizes}


def initialize_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> torch.device:
    """Start this process's rank of the job's process group (idempotent)
    and return the device the rank trains on.

    With explicit arguments (``coordinator_address`` ``host:port``, the
    job's ``num_processes`` and this ``process_id``) the group meets at
    ``tcp://<coordinator_address>``. With none, a launcher's environment
    is read when it marks a cluster (:func:`_cluster_env_present`:
    torchrun's ``WORLD_SIZE`` > 1, SLURM, Open MPI, the TPU and multislice
    markers): ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
    With neither, the job is one process and no group starts.

    A declared or detected cluster that fails to start raises (a missing
    variable, an unreachable coordinator, a peer that never joins within
    ``timeout_s``, the JAX package's ``initialization_timeout``): it never
    degrades to N independent single-process jobs.

    ``device="cuda"`` is this rank's card: ``cuda:<LOCAL_RANK>``, else
    ``cuda:<process_id % device_count>``; ``"cpu"`` the CPU. ``backend``
    defaults to NCCL on a card and gloo on the CPU; naming it (gloo for
    several ranks on one card, which NCCL refuses) is the only way to get
    another.
    """
    explicit = coordinator_address is not None or num_processes is not None
    if dist.is_initialized():
        return _rank_device(device, dist.get_rank())
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "an explicit cluster needs coordinator_address, num_processes and "
                f"process_id; got {coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r}")
        world, rank = int(num_processes), int(process_id)
        address = coordinator_address
    elif _cluster_env_present():
        missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(v)]
        if missing:
            raise ValueError(
                f"a cluster was detected in the environment but {missing} are unset: "
                "launch with torchrun or pass coordinator_address/num_processes/process_id")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        logger.info("single-process runtime (no cluster arguments or metadata)")
        return resolve_device(device)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {address!r}")
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    # NCCL binds the rank's card at once: the world communicator forms here
    # (a peer that never comes fails the start, not the first collective),
    # and every later subgroup splits from it on every rank in the order
    # the ranks create them, so no two ranks can wait on each other's
    # first collective of different groups.
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    global _ACTIVE, _TIMEOUT
    _ACTIVE = None
    _GROUPS.clear()
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    logger.info("process group: backend=%s world=%d rank=%d device=%s",
                backend, world, rank, dev)
    return dev


def collective_timeout() -> datetime.timedelta:
    """How long a collective of the job may wait for its peers: the
    ``timeout_s`` the process group started with."""
    if _TIMEOUT is None:
        raise RuntimeError("no process group: call initialize_runtime first")
    return _TIMEOUT


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local else rank % torch.cuda.device_count())
    return dev


def _cluster_env_present() -> bool:
    """True only for genuinely multi-process environment markers.

    The JAX package's markers (a coordinator address, a TPU host list of
    more than one host or a nonzero TPU worker id, SLURM or Open MPI job
    sizes above one) and torchrun's ``WORLD_SIZE`` above one. A one-entry
    ``TPU_WORKER_HOSTNAMES=localhost`` is not a cluster.
    """
    env = os.environ.get
    if env("COORDINATOR_ADDRESS") or env("MEGASCALE_COORDINATOR_ADDRESS"):
        return True
    hostnames = env("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hostnames.split(",") if h.strip()]) > 1:
        return True
    try:
        if int(env("TPU_WORKER_ID", "0")) > 0:
            return True
    except ValueError:
        pass
    for count_var in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        try:
            if int(env(count_var, "0")) > 1:
                return True
        except ValueError:
            pass
    return False


def shutdown_runtime() -> None:
    """Leave the process group, if one was started (``jax.distributed.shutdown``),
    with the active mesh and its subgroups."""
    global _ACTIVE, _TIMEOUT
    _ACTIVE = None
    _TIMEOUT = None
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (``jax.process_index``): 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes of the job (``jax.process_count``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def barrier() -> None:
    """Every rank waits here for the others; nothing happens in one process."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The job's ranks laid out over named axes: ``shape`` maps each axis
    to its size in :data:`AXIS_ORDER` order, and ``rank`` sits at
    ``coords`` (row-major, the JAX package's reshape of its device list)."""

    shape: Mapping[str, int]
    rank: int = 0

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict[str, int]:
        out, rest = {}, self.rank
        for axis in reversed(self.axis_names):
            rest, out[axis] = divmod(rest, self.shape[axis])
        return {a: out[a] for a in self.axis_names}


def build_mesh(
    spec: MeshSpec | Mapping[str, int] | None = None,
    *,
    world_size: int | None = None,
    rank: int | None = None,
) -> Mesh:
    """The mesh of ``spec`` (default ``{"data": -1}``: pure data
    parallelism over every rank) resolved against ``world_size`` ranks
    (default the process group's), seen from ``rank`` (default this one).

    Without ``world_size`` and ``rank`` it is the job's mesh: it becomes
    the active mesh and, under a process group, makes its subgroups
    (:func:`axis_group`). Every rank must then build the same meshes in the
    same order, as ``dist.new_group`` requires."""
    if spec is None:
        spec = MeshSpec({"data": -1})
    elif not isinstance(spec, MeshSpec):
        spec = MeshSpec(dict(spec))
    job = world_size is None and rank is None
    n = process_count() if world_size is None else int(world_size)
    r = process_index() if rank is None else int(rank)
    if not 0 <= r < n:
        raise ValueError(f"rank {r} outside [0, {n})")
    mesh = Mesh(spec.resolve(n), r)
    if job:
        _activate(mesh)
    return mesh


# The job's mesh, and per mesh shape this rank's group of every set of
# nontrivial axes (None: a set of size 1, or no process group).
_ACTIVE: Mesh | None = None
_GROUPS: dict[tuple, dict[tuple[str, ...], object]] = {}
_TIMEOUT: datetime.timedelta | None = None  # the job's, from initialize_runtime


def _shape_key(mesh: Mesh) -> tuple:
    return tuple(mesh.shape.items())


def _activate(mesh: Mesh) -> None:
    """Make ``mesh`` the job's active mesh, creating its subgroups on first
    use of its shape: for every set of axes of size > 1 (in
    :data:`AXIS_ORDER` order, smaller sets first), one ``dist.new_group``
    per line, called on every rank in one order. A set spanning the whole
    job uses the world group."""
    global _ACTIVE
    key = _shape_key(mesh)
    if key not in _GROUPS and process_count() > 1:
        live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
        groups: dict[tuple[str, ...], object] = {}
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                if k == len(live):
                    groups[axes] = dist.group.WORLD
                    continue
                for line in _lines(mesh, axes):
                    group = dist.new_group(line)
                    if mesh.rank in line:
                        groups[axes] = group
        _GROUPS[key] = groups
    _ACTIVE = mesh


def _lines(mesh: Mesh, axes: Sequence[str]) -> list[list[int]]:
    """The ranks partitioned into lines along ``axes``: ranks that share
    their coordinates on every other axis, each line in rank order (which
    is row-major order along ``axes``)."""
    others = [a for a in mesh.axis_names if a not in axes]
    lines: dict[tuple, list[int]] = {}
    for r in range(mesh.size):
        coords = Mesh(mesh.shape, r).coords
        lines.setdefault(tuple(coords[a] for a in others), []).append(r)
    return [lines[k] for k in sorted(lines)]


def active_mesh() -> Mesh:
    """The job's mesh: the last one :func:`build_mesh` built for the process
    group, or ``{"data": -1}`` over it when none was built."""
    if _ACTIVE is None or _ACTIVE.size != process_count():
        return build_mesh()
    return _ACTIVE


def _live_axes(mesh: Mesh, axes: str | Sequence[str]) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh {dict(mesh.shape)}")
    return tuple(a for a in mesh.axis_names if a in axes and mesh.shape[a] > 1)


def axis_ranks(mesh: Mesh, axes: str | Sequence[str]) -> list[int]:
    """The global ranks of this rank's line along ``axes`` (several axes:
    their product), in coordinate order; ``[mesh.rank]`` on axes of size 1."""
    live = _live_axes(mesh, axes)
    if not live:
        return [mesh.rank]
    return next(line for line in _lines(mesh, live) if mesh.rank in line)


def axis_group(mesh: Mesh, axes: str | Sequence[str]):
    """This rank's process group along ``axes`` (several axes: their
    product) of the active job mesh ``mesh``: None when the axes have size
    1, the world group when they span the job. Raises for a mesh that is not
    the job's (a planning mesh built with ``world_size``/``rank``)."""
    live = _live_axes(mesh, axes)
    if not live:
        return None
    groups = _GROUPS.get(_shape_key(mesh))
    if groups is None or mesh.size != process_count() or mesh.rank != process_index():
        raise ValueError(
            f"mesh {dict(mesh.shape)} at rank {mesh.rank} is not this job's mesh: "
            "build it with build_mesh(spec) under the process group")
    return groups[live]


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes over which the global batch is sharded (DP-like axes)."""
    return tuple(a for a in ("replica", "data") if a in mesh.axis_names)


def coordinate(mesh: Mesh, axes: Sequence[str]) -> int:
    """This rank's position along ``axes``, flattened row-major."""
    coords = mesh.coords
    index = 0
    for axis in axes:
        index = index * mesh.shape[axis] + coords[axis]
    return index


def _row_axes(mesh: Mesh, extra_axes: Sequence[str]) -> tuple[str, ...]:
    return tuple(data_axes(mesh)) + tuple(a for a in extra_axes if a in mesh.axis_names)


def local_batch_size(global_batch: int, mesh: Mesh, extra_axes: Sequence[str] = ()) -> int:
    """This rank's rows of the global batch.

    The single rule every loader follows (``data/loader.py``,
    ``data/text.py``): the rows shard evenly over the data axes (and
    ``extra_axes``, mesh axes the rows also shard over), each rank
    materialising its contiguous slice (:func:`process_rows`). A rank is a
    process holding one mesh position, so its slice is the JAX package's
    per-device shard. Raises on a batch the row partition does not divide.
    """
    n_data = math.prod(mesh.shape[a] for a in _row_axes(mesh, extra_axes))
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} not divisible by {n_data}")
    return global_batch // n_data


def process_rows(global_batch: int, mesh: Mesh | None = None,
                 extra_axes: Sequence[str] = ()) -> tuple[int, int]:
    """``(start, stop)`` of this rank's contiguous rows of ``global_batch``
    on ``mesh`` (default the active mesh): the rows split over the data
    axes and ``extra_axes`` (``("expert",)`` under the token-sharded MoE
    layout), in mesh order; ranks along the other axes (``"model"``,
    ``"seq"``, ``"pipeline"``) get the same rows."""
    if mesh is None:
        mesh = active_mesh()
    n = local_batch_size(global_batch, mesh, extra_axes)
    start = coordinate(mesh, _row_axes(mesh, extra_axes)) * n
    return start, start + n


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A dp/tp replan onto a surviving device set (see
    :func:`plan_elastic_mesh`). ``axes`` feeds straight into
    :func:`build_mesh`; ``notes`` records every fallback taken, in order."""

    axes: dict[str, int]
    n_devices: int      # devices the plan actually uses (dp * tp)
    dp: int
    tp: int
    grad_accum: int
    global_batch: int
    notes: tuple[str, ...] = ()


def plan_elastic_mesh(
    surviving: int | Sequence,
    *,
    tp: int = 1,
    global_batch: int = 0,
    grad_accum: int = 1,
    old_dp: int = 0,
) -> ElasticPlan:
    """Replan dp/tp onto the devices that survived a host loss.

    Never refuse a survivable topology, always log what was given up:

    - ``tp`` that no longer divides the survivors falls back to its
      largest divisor that does (worst case 1 = pure DP);
    - ``dp`` shrinks to the largest width dividing ``global_batch``
      (loaders require exact divisibility), idling the remainder;
    - ``grad_accum`` is rescaled by ``old_dp / new_dp`` (rounded up to a
      divisor of the per-device rows) so the global batch is preserved
      while the per-microslice device memory stays at the old level.
    """
    n = surviving if isinstance(surviving, int) else len(surviving)
    if n < 1:
        raise ValueError(f"need at least one surviving device, got {n}")
    notes: list[str] = []
    tp = max(int(tp), 1)
    if tp > 1 and (tp > n or n % tp):
        new_tp = max(d for d in range(1, min(tp, n) + 1) if tp % d == 0 and n % d == 0)
        notes.append(
            f"tp={tp} does not divide {n} surviving devices; falling back "
            f"to tp={new_tp}"
        )
        tp = new_tp
    dp = n // tp
    if global_batch and global_batch % dp:
        new_dp = max(d for d in range(1, dp + 1) if global_batch % d == 0)
        notes.append(
            f"global batch {global_batch} not divisible by dp={dp}; "
            f"shrinking to dp={new_dp} (idling {(dp - new_dp) * tp} "
            "surviving devices)"
        )
        dp = new_dp
    ga = max(int(grad_accum), 1)
    if old_dp and global_batch and old_dp != dp:
        scaled = ga * old_dp / dp
        new_ga = max(int(-(-scaled // 1)), 1)  # ceil
        per_dev = global_batch // dp
        while per_dev % new_ga and new_ga < per_dev:
            new_ga += 1
        if new_ga != ga:
            notes.append(
                f"grad_accum {ga} -> {new_ga} (dp {old_dp} -> {dp}; global "
                f"batch {global_batch} preserved)"
            )
            ga = new_ga
    axes = {"data": dp}
    if tp > 1:
        axes["model"] = tp
    for note in notes:
        logger.warning("elastic re-mesh: %s", note)
    return ElasticPlan(axes=axes, n_devices=dp * tp, dp=dp, tp=tp, grad_accum=ga,
                       global_batch=global_batch, notes=tuple(notes))


@dataclasses.dataclass(frozen=True)
class DisaggPlan:
    """A prefill/decode role split over one device slice (see
    :func:`plan_disagg_mesh`). ``*_device_ids`` index into the caller's
    device list; ``*_axes`` feed :func:`build_mesh`. ``fell_back`` means
    the roles share devices because the slice was too small to split;
    ``notes`` records every fallback taken, in order."""

    prefill_axes: dict[str, int]
    decode_axes: dict[str, int]
    prefill_device_ids: tuple[int, ...]
    decode_device_ids: tuple[int, ...]
    fell_back: bool = False
    notes: tuple[str, ...] = ()


def plan_disagg_mesh(
    n_devices: int,
    *,
    prefill_devices: int = -1,
    prefill_tp: int = 1,
    decode_tp: int = 1,
) -> DisaggPlan:
    """Plan a prefill/decode engine-role split onto one device slice.

    ``prefill_devices=-1`` means "half the slice, at least one device".
    Never refuse a plannable topology, always note what was given up: a
    slice of one device colocates the roles (``fell_back=True``); an
    explicit ``prefill_devices`` that would leave no decode device shrinks
    to leave one; a role ``tp`` that does not divide its devices falls back
    to the largest divisor that does. Invalid inputs (``n_devices < 1``,
    non-positive explicit ``prefill_devices``, non-positive tp) raise
    ``ValueError``.
    """
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if prefill_devices != -1 and prefill_devices < 1:
        raise ValueError(
            f"prefill_devices must be -1 (auto) or >= 1, got {prefill_devices}"
        )
    if prefill_tp < 1 or decode_tp < 1:
        raise ValueError(
            f"role tp must be >= 1, got prefill_tp={prefill_tp} "
            f"decode_tp={decode_tp}"
        )
    notes: list[str] = []
    if n_devices < 2:
        notes.append(
            "slice too small to split roles; colocating prefill and decode "
            "on the same device"
        )
        ids = tuple(range(n_devices))
        pre_ids, dec_ids, fell_back = ids, ids, True
    else:
        n_pre = prefill_devices if prefill_devices != -1 else n_devices // 2
        if n_pre >= n_devices:
            notes.append(
                f"prefill_devices={n_pre} would leave no decode devices on "
                f"a {n_devices}-device slice; shrinking to {n_devices - 1}"
            )
            n_pre = n_devices - 1
        pre_ids = tuple(range(n_pre))
        dec_ids = tuple(range(n_pre, n_devices))
        fell_back = False

    def _role_axes(role: str, tp: int, n: int) -> dict[str, int]:
        if tp > 1 and (tp > n or n % tp):
            new_tp = max(
                d for d in range(1, min(tp, n) + 1) if tp % d == 0 and n % d == 0
            )
            notes.append(
                f"{role} tp={tp} does not divide its {n} devices; falling "
                f"back to tp={new_tp}"
            )
            tp = new_tp
        axes = {"data": n // tp}
        if tp > 1:
            axes["model"] = tp
        return axes

    prefill_axes = _role_axes("prefill", prefill_tp, len(pre_ids))
    decode_axes = _role_axes("decode", decode_tp, len(dec_ids))
    for note in notes:
        logger.warning("disagg role plan: %s", note)
    return DisaggPlan(
        prefill_axes=prefill_axes,
        decode_axes=decode_axes,
        prefill_device_ids=pre_ids,
        decode_device_ids=dec_ids,
        fell_back=fell_back,
        notes=tuple(notes),
    )


# Short axis tags for layout labels, keyed by the canonical axis names.
_AXIS_SHORT = {
    "replica": "rep",
    "data": "dp",
    "pipeline": "pp",
    "expert": "ep",
    "seq": "sp",
    "model": "tp",
}


def layout_label(mesh: Mesh) -> str:
    """Compact tag for a mesh layout: size-1 axes are dropped, ``{"data":
    2, "model": 4}`` -> ``"dp2-tp4"``, a one-rank mesh -> ``"single"``."""
    parts = [
        f"{_AXIS_SHORT.get(a, a)}{mesh.shape[a]}"
        for a in mesh.axis_names
        if mesh.shape[a] > 1
    ]
    return "-".join(parts) or "single"
