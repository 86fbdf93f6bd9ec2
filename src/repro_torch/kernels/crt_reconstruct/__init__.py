from .kernel import requant_garner, requant_garner_plain

__all__ = ["requant_garner", "requant_garner_plain"]
