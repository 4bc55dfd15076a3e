"""Client churn: seeded arrive / depart / rejoin lifecycles."""
