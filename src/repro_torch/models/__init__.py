"""The dense model family of the port, with its flash-attention path."""
