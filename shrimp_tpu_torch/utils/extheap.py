"""Exact replica of the reference's explicit binary min-heap (DEF_EXTHEAP,
common/heap.h:226-300).

The *array layout* of this heap — not just its contents — matters for output
parity: pass-2 consumes candidates in heap-array order, and every downstream
tie (duplicate-removal dominant pick, final score sort) is broken by that
order through glibc's stable qsort.  So top-k selection must reproduce
insert/percolate behaviour move for move.
"""

from __future__ import annotations


def insert(a: list, load: int, item, key) -> int:
    """extheap_insert + percolate_up (heap.h:226-242,287-293)."""
    if load < len(a):
        a[load] = item
    else:
        a.append(item)
    load += 1
    node = load
    while node > 1 and key(a[node - 1]) < key(a[node // 2 - 1]):
        a[node - 1], a[node // 2 - 1] = a[node // 2 - 1], a[node - 1]
        node //= 2
    return load


def replace_min(a: list, load: int, item, key) -> None:
    """extheap_replace_min: overwrite root + percolate_down
    (heap.h:245-272,295-300)."""
    a[0] = item
    node = 1
    while True:
        left = node * 2
        right = left + 1
        mn = node
        if left <= load and key(a[left - 1]) < key(a[mn - 1]):
            mn = left
        if right <= load and key(a[right - 1]) < key(a[mn - 1]):
            mn = right
        if mn == node:
            break
        a[mn - 1], a[node - 1] = a[node - 1], a[mn - 1]
        node = mn


def topk_select(items, keys, K: int, thresholds_ok=None) -> list[int]:
    """Reference top-k selection over a candidate stream
    (read_get_vector_hits / readpair_get_vector_hits): returns the selected
    *indices* in final heap-array order.

    items: iterable of indices in stream order; keys[i] the selection key;
    a candidate enters only if load < K or key > current min.
    """
    heap: list[int] = []
    load = 0
    for i in items:
        if load < K:
            load = insert(heap, load, i, lambda j: keys[j])
        elif keys[i] > keys[heap[0]]:
            replace_min(heap, load, i, lambda j: keys[j])
    return heap[:load]
