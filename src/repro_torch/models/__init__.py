"""Learning on b-bit signatures (``linear``)."""
