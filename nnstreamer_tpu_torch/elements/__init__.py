"""Stream-graph elements (L4). Importing this package registers the
port's built-in elements with the runtime registry."""

from . import aggregator  # noqa: F401
from . import basic  # noqa: F401
from . import combiners  # noqa: F401
from . import condition  # noqa: F401
from . import converter  # noqa: F401
from . import crop  # noqa: F401
from . import datarepo  # noqa: F401
from . import decoder  # noqa: F401
from . import devicesrc  # noqa: F401
from . import filter  # noqa: F401
from . import rate  # noqa: F401
from . import repo  # noqa: F401
from . import sensorsrc  # noqa: F401
from . import sparse  # noqa: F401
from . import trainer  # noqa: F401
from . import transform  # noqa: F401
