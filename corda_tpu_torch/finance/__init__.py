"""Finance: reference contracts + flows (the `finance/` module of the
reference — Cash, CommercialPaper, Obligation and the cash flows)."""
from .cash import Cash, CashState  # noqa: F401
from .commercial_paper import CommercialPaper, CommercialPaperState  # noqa: F401
from .commodity import Commodity, CommodityContract, CommodityState  # noqa: F401
from .deal import TwoPartyDealFlow  # noqa: F401
from .flows import CashIssueFlow, CashPaymentFlow, CashExitFlow  # noqa: F401
from .obligation import Obligation, ObligationState  # noqa: F401
from .trade import BuyerFlow, SellerFlow  # noqa: F401
