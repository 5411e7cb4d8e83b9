"""Device-history budget for the lazy facade histories.

Port of ``inference_tpu.utils.history``. ``HamiltonianChain`` keeps its
output history chunks on the device until a host view is requested
(``get_sample`` and the rest) or the device bytes it holds pass
``DEVICE_HISTORY_LIMIT``; then it moves them to the host in one transfer.
"""

# offload device-held history once it exceeds this many bytes, bounding
# device-memory growth on very long runs
DEVICE_HISTORY_LIMIT = 2**30
