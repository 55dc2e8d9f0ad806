"""Paged-KV continuous-batching serving: block pool, policies, scheduler, engine."""
