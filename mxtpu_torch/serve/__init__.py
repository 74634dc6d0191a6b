"""mxtpu_torch.serve — continuous-batching serving over the llama slot
bank, the port of ``mxtpu.serve``'s dense engine (the paged pool,
speculative decoding and the gateway come with later slices)."""
from .engine import (KVHandoff, Request, ServeEngine, bucket_for,
                     cancel_counter, resume_key)

__all__ = ["Request", "KVHandoff", "ServeEngine", "bucket_for",
           "resume_key", "cancel_counter"]
