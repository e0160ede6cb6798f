"""Stream-graph elements (L4). Importing this package registers the
port's built-in elements with the runtime registry."""

from . import basic  # noqa: F401
from . import converter  # noqa: F401
from . import crop  # noqa: F401
from . import decoder  # noqa: F401
from . import devicesrc  # noqa: F401
from . import filter  # noqa: F401
from . import transform  # noqa: F401
