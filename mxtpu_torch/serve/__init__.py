"""mxtpu_torch.serve — continuous-batching serving over the llama slot
bank or a paged KV pool, with speculative decoding over the pool (the
port of ``mxtpu.serve``'s engine), and the serving tier over it in
``mxtpu_torch.serve.gateway``: replicas behind a router, the HTTP front
door, the autoscaler and disaggregated prefill/decode. The gateway's
names are exported here too. The fleet control plane over it — named
models, chip arbitration, live hot swaps and the train→serve flywheel —
is ``mxtpu_torch.serve.fleet``, imported on first use as the
reference's is (the engine alone does not pay for it)."""
from .engine import (KVHandoff, PageAllocator, PrefixCache, Request,
                     ServeEngine, bucket_for, cancel_counter, ngram_drafter,
                     resume_key)
from . import gateway
from .gateway import (PRIORITIES, AutoscalePolicy, Autoscaler,
                      CircuitBreaker, DisaggBackend, EngineReplica, Gateway,
                      GatewayClient, GatewayClosed, GatewayOverloaded,
                      GatewayUnavailable, KVChannel, NoHealthyReplicas,
                      PrefillWorker, ReplicaSet, ReplicaSupervisor,
                      RequestHandle, Ticket)

__all__ = ["Request", "KVHandoff", "ServeEngine", "bucket_for",
           "resume_key", "cancel_counter", "PageAllocator", "PrefixCache",
           "ngram_drafter", "gateway", "fleet"] + list(gateway.__all__)


def __getattr__(name):
    if name == "fleet":
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
