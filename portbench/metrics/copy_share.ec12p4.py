"""Host-device copies over device busy time in the traced window, in %."""

from portbench.readers import copy_share as read  # noqa: F401
