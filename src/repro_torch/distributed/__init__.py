"""The device mesh, the ambient mesh context and the codec sharded over it
(`sharding`), fault tolerance for the training loop (`fault`: the restart
manager and the straggler watchdog) and error-feedback int8 compression
(`compression`)."""
