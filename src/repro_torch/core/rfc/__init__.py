"""The RFC format (paper C3): the plain codec, the storage-cost model and
RFC-checkpointed activations."""
