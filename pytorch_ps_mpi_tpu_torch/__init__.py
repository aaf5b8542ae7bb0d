"""PyTorch/CUDA port of the parameter-server framework.

The JAX package `pytorch_ps_mpi_tpu` is the reference each part of this
one is held against; this package imports ``torch`` and numpy, never JAX
and nothing of the JAX package.  Ported so far: the synchronous PS step
(`MPI_PS`, `SGD`, `Adam`, `AdamW`) with every gradient codec of the JAX
package, error feedback, ZeRO, EMA, gradient accumulation, remat, the lr
schedules, the replica-consensus guard and in-memory checkpoint state;
the in-process async PS (`AsyncPS`, `AsyncSGD`, `AsyncAdam`: worker
threads on CUDA streams, quota'd fills, the robust reducers); the
single-PS multihost async PS over TCP (`AsyncPSServer`, `AsyncSGDServer`,
`AsyncAdamServer`, `AsyncPSWorker`: worker processes, the JAX package's
v12 frames, `transport`, gradients streamed in buckets); the serve
tier on a single PS (`serve`: `Subscriber`, a versioned snapshot
subscription over SUBS/DELT with delta snapshots, and
`InferenceFrontend`, a continuous-batching greedy decoder that hot-swaps
the subscribed parameters); the sharded PS fleet (`shard`: `PSFleet`
with hot standbys promoted onto a dead shard's port and coordinated
snapshots, `ShardRouter`, `ShardPlan`, and the fleet's reader
`FleetSubscriber`); the two-level hierarchy (`LocalAggregator`,
`GroupWorker`, `Hierarchy`: group-local aggregators forwarding one AGGR
frame a fill to a single PS or a fleet);
the reference's nonblocking collectives (`parallel.collectives`'s
``i*`` ops); the multi-rank LM paths over a named mesh (`make_ps_mesh`
and the other mesh constructors of `parallel.mesh`, `MPI_PS(mesh=, axis=,
batch_spec=)`, the differentiable in-step collectives, ring and Ulysses
attention, tensor, pipeline and expert parallelism); the blockq and bf16 codecs' kernels are hand-written CUDA
for Hopper (``csrc/codec_kernels.cu``); the ResNet/MLP models and the
transformer LM (dense, or with dense MoE MLPs: `models.moe`), whose flash
attention forward and backward are hand-written CUDA too
(``csrc/flash_attention.cu``, `ops.flash_attention`); and the synthetic
data the step trains on.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

from .async_ps import AsyncAdam, AsyncPS, AsyncSGD
from .errors import (AggregatorDeadError, BufferMutatedError,
                     ElasticResumeError,
                     FillStarvedError, FleetDeadError, FleetManifestError,
                     FleetResumeSkewError, InferShedError,
                     NativeToolchainError, NotCompiledError, PSRuntimeError,
                     SDCDetectedError, ShardDeadError, SnapshotRewindError,
                     WorkerFailedError)
from .multihost_async import (AsyncAdamServer, AsyncPSServer,
                              AsyncPSWorker, AsyncSGDServer)
from .ops.codecs import (BlockQuantizeCodec, CastCodec, Codec, IdentityCodec,
                         QuantizeCodec, SignCodec, TopKCodec, get_codec)
from .ops.flash_attention import flash_attention
from .ops.robust import ReducerCodecError
from .parallel.mesh import make_ps_group, make_ps_mesh
from .ps import MPI_PS, PS, SGD, Adam, AdamW
from .serve import (FleetSubscriber, InferenceFrontend, InferRequest,
                    Subscriber)
from .shard import (GroupWorker, Hierarchy, LocalAggregator, PSFleet,
                    ShardPlan, ShardRouter, build_shard_plan,
                    match_partition_rules)
from .utils import checkpoint
from .utils.checkpoint import CheckpointError
from .utils.faults import FaultPlan, SimulatedCrash

__all__ = [
    "MPI_PS",
    "PS",
    "SGD",
    "Adam",
    "AdamW",
    "AsyncPS",
    "AsyncSGD",
    "AsyncAdam",
    "AsyncPSServer",
    "AsyncSGDServer",
    "AsyncAdamServer",
    "AsyncPSWorker",
    "make_ps_group",
    "make_ps_mesh",
    "Codec",
    "IdentityCodec",
    "CastCodec",
    "BlockQuantizeCodec",
    "TopKCodec",
    "QuantizeCodec",
    "SignCodec",
    "get_codec",
    "flash_attention",
    "PSRuntimeError",
    "NotCompiledError",
    "SDCDetectedError",
    "ElasticResumeError",
    "WorkerFailedError",
    "FleetDeadError",
    "FillStarvedError",
    "checkpoint",
    "CheckpointError",
    "FaultPlan",
    "SimulatedCrash",
    "NativeToolchainError",
    "BufferMutatedError",
    "InferShedError",
    "SnapshotRewindError",
    "Subscriber",
    "InferenceFrontend",
    "InferRequest",
    "PSFleet",
    "ShardPlan",
    "ShardRouter",
    "build_shard_plan",
    "match_partition_rules",
    "ShardDeadError",
    "FleetManifestError",
    "FleetResumeSkewError",
    "FleetSubscriber",
    "LocalAggregator",
    "GroupWorker",
    "Hierarchy",
    "AggregatorDeadError",
    "ReducerCodecError",
]
