"""Request classification: tenant and priority class.

Counterpart of ``gordo_components_tpu/qos/classify.py``. One identity a
request, ``RequestClass(tenant, qos_class)``, parsed from the
``X-Gordo-Tenant`` and ``X-Gordo-Priority`` headers and overlaid by the
``{"tenant", "priority"}`` keys of a tensor body's ``__meta__`` sidecar
(:func:`classify_meta`): the shared-memory ring has no headers, so there
the sidecar is the only carrier. The goodput ledger keys its
per-(tenant, class) cells on it. Tenant labels are bounded when
they are made: only tenants named in the QoS configuration keep their
own label, any other collapses to ``other``, so no flood of tenant
strings can grow a metric family.
"""

from dataclasses import dataclass
from typing import Any, Mapping, Optional

#: priority classes, strongest first; untagged traffic is ``interactive``
CLASSES = ("interactive", "batch", "best_effort")

DEFAULT_CLASS = "interactive"
DEFAULT_TENANT = "default"
#: the label of every tenant the QoS configuration does not name
OTHER_TENANT = "other"

TENANT_HEADER = "X-Gordo-Tenant"
PRIORITY_HEADER = "X-Gordo-Priority"

# accepted spellings -> canonical class
_CLASS_ALIASES = {
    "interactive": "interactive",
    "online": "interactive",
    "batch": "batch",
    "bulk": "batch",
    "best_effort": "best_effort",
    "best-effort": "best_effort",
    "besteffort": "best_effort",
}


def normalize_class(value: Any, default: str = DEFAULT_CLASS) -> str:
    """The canonical priority class of ``value``; an unknown or empty one
    is ``default`` (a typo degrades to ordinary service)."""
    if not isinstance(value, str):
        return default
    return _CLASS_ALIASES.get(value.strip().lower(), default)


def normalize_tenant(value: Any) -> str:
    """The tenant string, trimmed to 64 characters and without ``|`` (the
    tenant|class join of the ledger's keys); not yet bounded."""
    if not isinstance(value, str):
        return DEFAULT_TENANT
    tenant = value.strip().replace("|", "_")[:64]
    return tenant if tenant else DEFAULT_TENANT


@dataclass(frozen=True)
class RequestClass:
    """A request's QoS identity: who sent it, how urgent it is."""

    tenant: str = DEFAULT_TENANT
    qos_class: str = DEFAULT_CLASS

    def label_tenant(self, known_tenants) -> str:
        """The tenant as a metric label: itself when the configuration
        names it (or it is the default), ``other`` otherwise."""
        if self.tenant == DEFAULT_TENANT or (known_tenants and self.tenant in known_tenants):
            return self.tenant
        return OTHER_TENANT


#: the shared identity of untagged traffic
DEFAULT_REQUEST_CLASS = RequestClass()


def classify_headers(headers: Mapping[str, str]) -> RequestClass:
    """The QoS identity in a request's headers (missing: the defaults)."""
    tenant = headers.get(TENANT_HEADER)
    priority = headers.get(PRIORITY_HEADER)
    if not tenant and not priority:
        return DEFAULT_REQUEST_CLASS
    return RequestClass(tenant=normalize_tenant(tenant), qos_class=normalize_class(priority))


def classify_meta(meta: Optional[Mapping[str, Any]], base: Optional[RequestClass] = None) -> RequestClass:
    """``base`` (default: the untagged identity) with the ``__meta__``
    sidecar's ``tenant`` and ``priority`` keys laid over it: the sidecar
    wins where present. An unknown priority keeps ``base``'s class."""
    if base is None:
        base = RequestClass()
    if not meta:
        return base
    tenant, qos_class = base.tenant, base.qos_class
    if "tenant" in meta:
        tenant = normalize_tenant(meta.get("tenant"))
    if "priority" in meta:
        qos_class = normalize_class(meta.get("priority"), default=qos_class)
    if tenant == base.tenant and qos_class == base.qos_class:
        return base
    return RequestClass(tenant=tenant, qos_class=qos_class)
