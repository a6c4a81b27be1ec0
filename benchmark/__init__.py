"""The benchmark of gossip_protocol_tpu_torch (see README.md)."""
