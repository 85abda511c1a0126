from spfx_torch.stream.engine import StreamingCholesky, StreamingLU

__all__ = ["StreamingCholesky", "StreamingLU"]
