"""mxlint deep fixture (port idioms) — MXL301: the ``mxtpu_torch.serve``
import marks this module as a serve path; raw ``prng`` key draws
bypass the ``serve.resume_key`` chain. A documented chain root is
suppressed."""
from mxtpu_torch import prng
from mxtpu_torch.serve import resume_key


def sample(seed, logits):
    key = prng.PRNGKey(seed)  # seeded: MXL301
    key, sub = prng.split(key)  # seeded: MXL301
    return prng.categorical(sub, logits)


def root(seed):
    return prng.PRNGKey(seed)  # noqa: MXL301 — the chain root itself


def resumed(seed, n):
    return resume_key(seed, n)
