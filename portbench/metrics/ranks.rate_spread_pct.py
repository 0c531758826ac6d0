"""How unevenly the ranks of a cell over several cards map: 100 x (the
fastest rank's reads/s - the slowest rank's) / the mean rank's, each
rank's rate its window's reads over its window's seconds on the
harness's clock; None on a record with no ranks (a cell on one card)."""


def read(r):
    ranks = r.get("ranks")
    if not ranks:
        return None
    rates = [x["reads"] / x["window_s"] for x in ranks]
    return 100.0 * (max(rates) - min(rates)) / (sum(rates) / len(rates))
