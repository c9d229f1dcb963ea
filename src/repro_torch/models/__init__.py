"""Learning on b-bit signatures (``linear``) and the recsys models with
the minhash frontend (``recsys``, ``layers``)."""
