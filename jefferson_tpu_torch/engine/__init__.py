"""Render engine: host planning, the unfused chain, and the batched renderer."""
