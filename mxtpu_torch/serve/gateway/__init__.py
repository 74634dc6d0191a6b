"""Multi-replica serving tier over the port's ``ServeEngine``, the port
of ``mxtpu.serve.gateway``: an HTTP front door with admission control
and token streaming, a replica manager with least-loaded routing and
deadline/cancel plumbing, a disaggregated prefill/decode mode with a
framed-RPC KV handoff (``mxtpu_torch.rpc``), and a telemetry-driven
autoscaler. Host code over the engine: none of it launches a kernel.

    from mxtpu_torch.serve import ServeEngine
    from mxtpu_torch.serve.gateway import Gateway
    gw = Gateway(lambda: ServeEngine(cfg, params, max_slots=8),
                 n_replicas=2)
    port = gw.start_http()
    # POST /v1/generate streams tokens; GET /metrics is Prometheus

Disaggregated (DistServe-style) topology:

    from mxtpu_torch.serve.gateway import DisaggBackend
    gw = Gateway(backend=DisaggBackend(cfg, params, n_prefill=2,
                                       n_decode=2, max_slots=8))

The gateway takes no device of its own: the engine factory places the
engines, and ``DisaggBackend(device=...)`` its workers and engines (the
card unless told otherwise).

Routing and streaming keep the engine's contract end to end: each
request's tokens do not depend on the replica, the interleaving or the
topology, and that holds through failures: a supervisor restarts
dead/stalled replicas and the gateway re-dispatches their in-flight
requests past the already-streamed prefix with the rng chain
fast-forwarded, so a crash-surviving stream equals a fault-free one;
the disagg KV channel reconnects and re-authenticates, and a circuit
breaker falls back to colocated prefill under sustained prefill
failure.
"""
from .autoscale import AutoscalePolicy, Autoscaler
from .disagg import (CircuitBreaker, DisaggBackend, KVChannel,
                     PrefillWorker)
from .frontdoor import GatewayClient
from .gateway import (PRIORITIES, Gateway, GatewayOverloaded,
                      GatewayUnavailable, RequestHandle)
from .replica import (EngineReplica, GatewayClosed, NoHealthyReplicas,
                      ReplicaSet, ReplicaSupervisor, Ticket)

__all__ = ["Gateway", "GatewayOverloaded", "GatewayUnavailable",
           "GatewayClosed", "RequestHandle", "GatewayClient",
           "EngineReplica", "ReplicaSet", "ReplicaSupervisor",
           "NoHealthyReplicas", "Ticket", "DisaggBackend",
           "KVChannel", "PrefillWorker", "CircuitBreaker",
           "AutoscalePolicy", "Autoscaler", "PRIORITIES"]
