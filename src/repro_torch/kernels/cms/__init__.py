from .cms import KERNEL, cms_update_torch  # noqa: F401
from .ops import cms_update  # noqa: F401
