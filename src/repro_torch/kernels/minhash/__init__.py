# the wrapper ``minhash`` is ``ops.minhash``; exporting it here would hide
# the kernel module of the same name
from .minhash import KERNEL, MH_SEED, minhash_torch  # noqa: F401
