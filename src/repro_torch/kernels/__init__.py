"""Chunk fingerprinting on the device: the digest spec and its plain
versions (`ref`), the Hopper kernels' wrappers (`fingerprint`), word
streams and the one device->host fetch (`ops`), and the batched engine
(`batch`)."""
from . import batch, fingerprint, ops, ref
from .batch import digest_leaves, plan_leaves, tree_fingerprint_batched
from .fingerprint import fingerprint_words, fingerprint_words_cmp
from .ops import leaf_fingerprint, leaf_fingerprint_np, tree_fingerprint
