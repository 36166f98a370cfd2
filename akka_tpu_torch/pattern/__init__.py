"""Retry patterns of the port (`backoff.backoff_delay`)."""
