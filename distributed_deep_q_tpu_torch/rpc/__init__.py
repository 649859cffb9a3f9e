"""Actor↔learner RPC plane: wire protocol, ReplayFeed service, and the
fault-tolerance layer (retry/backoff, idempotent flushes, chaos injection).
Copies of the reference's ``rpc/`` modules; host only.
"""

from distributed_deep_q_tpu_torch.rpc.protocol import (  # noqa: F401
    ChecksumError, ProtocolError)
from distributed_deep_q_tpu_torch.rpc.resilience import (  # noqa: F401
    ResilientReplayFeedClient, RetryPolicy, RPCError)
