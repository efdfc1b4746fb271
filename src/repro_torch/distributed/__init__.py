"""The device mesh, the ambient mesh context and the codec sharded over it
(`sharding`), fault tolerance for the training loop (`fault`: the restart
manager and the straggler watchdog) and error-feedback int8 compression
(`compression`)."""
from .sharding import (RULES_MULTI_POD, RULES_SINGLE_POD, active_mesh,
                       constrain, named_sharding, resolve_spec, rules_for,
                       use_rules)
