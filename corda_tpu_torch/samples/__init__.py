"""Sample applications (own copies of the reference package's samples: the
rates oracle, the SIMM valuation, the trader, IRS, notary, attachment and
bank-of-corda demos and the multi-bank simulation)."""
