"""Generated raw quarterly statements: the chunker's input, from a seed.

Writes an ``extract_data`` tree, ``<prefix>_q{1..4}_2023/*.json``, with the
three statement roles that :func:`..data.chunker.classify_quarterly_files`
keys on (consolidated financial results, consolidated segmental results, the
balance sheet), so that the corpus loader, the CLI and the services can be
driven end to end where the reference repository's data is not mounted. The
figures are random but plausible; nothing here is read by the served paths.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.chunker import period_keys
from ..data.loader import DEFAULT_PERIOD_MAPPING

_SEGMENT_KEYS = ("retailBanking", "wholesaleBanking", "treasury", "lifeInsurance", "others")


def _series(rng, cur: str, prev: str, low: float, high: float, digits: int = 0) -> dict:
    now = float(rng.uniform(low, high))
    then = now / float(rng.uniform(1.02, 1.35))
    return {cur: round(now, digits), prev: round(then, digits)}


def quarter_statements(rng, period: str, company: str = "ICICI Bank Limited") -> dict[str, dict]:
    """The three statement files of one quarter, keyed by file stem."""
    cur, prev = period_keys(period)
    total_income = _series(rng, cur, prev, 40_000, 70_000)
    interest = {k: round(v * 0.8) for k, v in total_income.items()}
    other = {k: total_income[k] - interest[k] for k in total_income}
    expenditure = {k: round(v * float(rng.uniform(0.6, 0.75))) for k, v in total_income.items()}
    interest_exp = {k: round(v * 0.6) for k, v in expenditure.items()}
    fin = {
        "company": company,
        "reportType": "CONSOLIDATED FINANCIAL RESULTS",
        "consolidatedResults": {
            "income": {"totalIncome": total_income, "interestEarned": interest, "otherIncome": other},
            "expenses": {
                "totalExpenditure": expenditure,
                "interestExpended": interest_exp,
                "operatingExpenses": {k: expenditure[k] - interest_exp[k] for k in expenditure},
            },
            "profitAndLoss": {
                "operatingProfit": {k: total_income[k] - expenditure[k] for k in total_income},
                "netProfitForThePeriod": _series(rng, cur, prev, 8_000, 13_000),
                "provisions": _series(rng, cur, prev, 500, 2_500),
            },
            "ratios": {
                "earningsPerShare": {
                    "basic": _series(rng, cur, prev, 12, 19, 2),
                    "diluted": _series(rng, cur, prev, 11, 18, 2),
                }
            },
        },
    }
    revenue = {k: _series(rng, cur, prev, 2_000, 40_000) for k in _SEGMENT_KEYS}
    segmental = {
        "company": company,
        "reportType": "CONSOLIDATED SEGMENTAL RESULTS",
        "consolidatedSegmentalResults": {
            "segmentRevenue": revenue,
            "segmentResults": {
                k: {key: round(v * float(rng.uniform(0.1, 0.35))) for key, v in series.items()}
                for k, series in revenue.items()
            },
        },
    }
    balance = {
        "company": company,
        "consolidatedBalanceSheet": {
            "assets": {
                "totalAssets": _series(rng, cur, prev, 1_900_000, 2_400_000),
                "advances": _series(rng, cur, prev, 1_000_000, 1_300_000),
                "investments": _series(rng, cur, prev, 500_000, 800_000),
                "cashAndBalancesWithRBI": _series(rng, cur, prev, 60_000, 120_000),
            },
            "capitalAndLiabilities": {
                "deposits": _series(rng, cur, prev, 1_200_000, 1_500_000),
                "borrowings": _series(rng, cur, prev, 150_000, 250_000),
                "capital": _series(rng, cur, prev, 1_300, 1_500),
                "reservesAndSurplus": _series(rng, cur, prev, 200_000, 260_000),
            },
        },
    }
    return {"financial_results": fin, "segmental_results": segmental, "balance_sheet": balance}


def write_extract_data(root: str, seed: int = 0, prefix: str = "icici") -> str:
    """Write the four quarters under ``root`` and return it."""
    rng = np.random.default_rng(seed)
    for quarter, period in DEFAULT_PERIOD_MAPPING.items():
        folder = os.path.join(root, f"{prefix}_{quarter}")
        os.makedirs(folder, exist_ok=True)
        for stem, doc in quarter_statements(rng, period).items():
            with open(os.path.join(folder, stem + ".json"), "w") as f:
                json.dump(doc, f, indent=1)
    return root
