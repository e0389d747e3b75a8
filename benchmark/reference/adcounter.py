"""The advertisement counter's converged values, worked out plainly
(``riak_test/lasp_advertisement_counter_test.erl:65-235``): an ad's view
total is the number of its lanes that some replica incremented (one
actor a lane, max-merged); an ad stays live iff that total is under the
threshold; ``ads`` is the union of the two publishers' live ads,
``pairs`` their product with the contracts, ``active`` the pairs whose
contract the ad's index hashes onto."""

from __future__ import annotations

import numpy as np


def expected(inputs: dict) -> dict:
    n_pub, n_contracts = inputs["ads_per_publisher"], inputs["contracts"]
    n_lanes, threshold = inputs["view_lanes"], inputs["threshold"]
    n_ads = 2 * n_pub
    seeded = np.asarray(inputs["seeded_views"])
    totals = np.bincount(seeded // n_lanes, minlength=n_ads)
    live = {a for a in range(n_ads) if totals[a] < threshold}
    contracts = frozenset(f"c{j}" for j in range(n_contracts))
    ads = frozenset(f"ad{a}" for a in live)
    out = {
        "ads_a": frozenset(f"ad{a}" for a in live if a < n_pub),
        "ads_b": frozenset(f"ad{a}" for a in live if a >= n_pub),
        "contracts": contracts,
        "ads": ads,
        "pairs": frozenset((ad, c) for ad in ads for c in contracts),
        "active": frozenset((f"ad{a}", f"c{a % n_contracts}") for a in live),
    }
    for a in range(n_ads):
        out[f"views_{a}"] = int(totals[a])
    return out
