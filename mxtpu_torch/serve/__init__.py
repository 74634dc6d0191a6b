"""mxtpu_torch.serve — continuous-batching serving over the llama slot
bank or a paged KV pool, with speculative decoding over the pool: the
port of ``mxtpu.serve``'s engine (the gateway comes with a later
slice)."""
from .engine import (KVHandoff, PageAllocator, PrefixCache, Request,
                     ServeEngine, bucket_for, cancel_counter, ngram_drafter,
                     resume_key)

__all__ = ["Request", "KVHandoff", "ServeEngine", "bucket_for",
           "resume_key", "cancel_counter", "PageAllocator", "PrefixCache",
           "ngram_drafter"]
