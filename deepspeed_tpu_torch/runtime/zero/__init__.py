"""ZeRO config of the port (stage 0 only in this slice)."""
