"""Continuous-batching serving: paged KV pool + prefix trie + scheduler."""
from repro_torch.serve.engine import Request, ServeEngine, bucket
from repro_torch.serve.paging import NULL_PAGE, PageAllocator, PrefixTrie

__all__ = ["ServeEngine", "Request", "PageAllocator", "PrefixTrie",
           "NULL_PAGE", "bucket"]
