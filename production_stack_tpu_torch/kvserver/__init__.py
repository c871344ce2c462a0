"""Remote shared KV store (``kv://host:port``).

Counterpart of ``production_stack_tpu/kvserver/``: the cross-replica KV
tier, a length-prefixed binary TCP protocol with a raw little-endian
tensor serde (``protocol.py``), its blocking client (``client.py``) and
the pure-Python asyncio store (``server.py``).  Frames are byte-identical
to the JAX package's, so engines of either package share one store (and
the C++ server under ``native/kvserver/`` serves both).  Tensors cross as
torch CPU tensors; bf16 sides are raw uint16 on the wire.
"""
