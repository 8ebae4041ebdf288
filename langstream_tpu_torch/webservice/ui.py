"""Embedded web UI (the port's own copy of ``langstream_tpu/webservice/ui.py``,
the same page byte for byte; reference ``UIAppCmd`` — the page `langstream
docker run` serves): one static HTML app listing deployed applications,
their agents/gateways, the config-docs catalog, and a chat box speaking the
gateway websocket protocol. Served at ``GET /ui`` on the control plane."""

UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>langstream-tpu</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 0; display: flex; height: 100vh; }
  aside { width: 320px; border-right: 1px solid #ddd; padding: 16px; overflow-y: auto; }
  main { flex: 1; display: flex; flex-direction: column; padding: 16px; }
  h1 { font-size: 18px; margin: 0 0 12px; }
  h2 { font-size: 14px; margin: 16px 0 6px; color: #555; }
  .app { padding: 8px; border: 1px solid #e3e3e3; border-radius: 6px; margin-bottom: 8px;
         cursor: pointer; }
  .app.selected { border-color: #4a7; background: #f2fbf6; }
  .tag { display: inline-block; font-size: 11px; background: #eef; border-radius: 4px;
         padding: 1px 6px; margin: 1px; }
  #log { flex: 1; overflow-y: auto; border: 1px solid #ddd; border-radius: 6px;
         padding: 12px; margin-bottom: 8px; white-space: pre-wrap; }
  .me { color: #246; margin: 4px 0; }
  .bot { color: #161; margin: 4px 0; }
  .sys { color: #999; font-size: 12px; }
  form { display: flex; gap: 8px; }
  input[type=text] { flex: 1; padding: 8px; border: 1px solid #ccc; border-radius: 6px; }
  button { padding: 8px 16px; }
  small { color: #888; }
</style>
</head>
<body>
<aside>
  <h1>langstream-tpu</h1>
  <h2>Applications <small>(tenant <span id="tenant">default</span>)</small></h2>
  <div id="apps"><span class="sys">loading…</span></div>
  <h2>Agent catalog</h2>
  <div id="docs" class="sys">loading…</div>
</aside>
<main>
  <h2>Chat <small id="chat-target">select an app with a chat gateway</small></h2>
  <div id="log"></div>
  <form id="chat">
    <input type="text" id="msg" placeholder="message…" autocomplete="off">
    <button>Send</button>
  </form>
</main>
<script>
const tenant = new URLSearchParams(location.search).get("tenant") || "default";
document.getElementById("tenant").textContent = tenant;
const gatewayBase = new URLSearchParams(location.search).get("gateway") ||
  (/:\\d+$/.test(location.origin)
    ? location.origin.replace(/:\\d+$/, ":8091")
    : location.origin + ":8091");
let selected = null, ws = null;
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const log = (cls, text) => {
  const el = document.createElement("div");
  el.className = cls; el.textContent = text;
  const box = document.getElementById("log");
  box.appendChild(el); box.scrollTop = box.scrollHeight;
};
async function loadApps() {
  const box = document.getElementById("apps");
  const resp = await fetch(`/api/applications/${tenant}`);
  if (!resp.ok) {
    box.innerHTML = '<span class="sys">API error ' + resp.status +
      (resp.status === 401 ? " (authentication required)" : "") + '</span>';
    return;
  }
  const apps = await resp.json();
  const ids = apps.map(a => a["application-id"]);
  const existing = [...box.querySelectorAll(".app")].map(n => n.dataset.id);
  // don't wipe selection/expanded detail when nothing changed
  if (ids.length && ids.join() === existing.join()) return;
  box.innerHTML = "";
  for (const a of apps) {
    const el = document.createElement("div");
    el.className = "app";
    el.dataset.id = a["application-id"];
    el.textContent = a["application-id"];
    el.onclick = () => select(a["application-id"], el);
    box.appendChild(el);
  }
  if (!apps.length) box.innerHTML = '<span class="sys">no applications deployed</span>';
}
async function select(id, el) {
  document.querySelectorAll(".app").forEach(n => n.classList.remove("selected"));
  el.classList.add("selected");
  const resp = await fetch(`/api/applications/${tenant}/${id}`);
  if (!resp.ok) { log("sys", "describe failed: " + resp.status); return; }
  const desc = await resp.json();
  el.innerHTML = `<b>${esc(id)}</b><br>` +
    desc.agents.map(a => `<span class="tag">${esc(a.type)}</span>`).join("") +
    (desc.gateways || []).map(g => `<span class="tag">gw:${esc(g.id)}/${esc(g.type)}</span>`).join("");
  el.onclick = () => select(id, el);
  const chat = (desc.gateways || []).find(g => g.type === "chat");
  if (ws) { ws.close(); ws = null; }
  if (chat) {
    selected = {app: id, gateway: chat.id};
    document.getElementById("chat-target").textContent = `${id} → ${chat.id}`;
    // only pass params the gateway declares (unknown params are a 400)
    const q = (chat.parameters || []).includes("sessionId")
      ? `?param:sessionId=ui-${Date.now()}` : "";
    const url = gatewayBase.replace(/^http/, "ws") +
      `/v1/chat/${tenant}/${id}/${encodeURIComponent(chat.id)}` + q;
    ws = new WebSocket(url);
    ws.onmessage = ev => {
      const push = JSON.parse(ev.data);
      if (push.record) log("bot", push.record.value);
    };
    ws.onopen = () => log("sys", "connected");
    ws.onclose = () => log("sys", "disconnected");
    ws.onerror = () => log("sys", "chat gateway unreachable (is " + gatewayBase +
      " right? pass ?gateway=http://host:port)");
  } else {
    selected = null;
    document.getElementById("chat-target").textContent = `${id} has no chat gateway`;
  }
}
document.getElementById("chat").onsubmit = ev => {
  ev.preventDefault();
  const input = document.getElementById("msg");
  if (!ws || ws.readyState !== 1 || !input.value) return;
  ws.send(JSON.stringify({value: input.value}));
  log("me", input.value);
  input.value = "";
};
async function loadDocs() {
  const resp = await fetch("/api/docs");
  if (!resp.ok) {
    document.getElementById("docs").textContent = "API error " + resp.status;
    return;
  }
  const docs = await resp.json();
  document.getElementById("docs").innerHTML =
    Object.keys(docs.agents).map(t => `<span class="tag">${esc(t)}</span>`).join("");
}
loadApps(); loadDocs(); setInterval(loadApps, 10000);
</script>
</body>
</html>
"""
